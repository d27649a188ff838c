"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use by ``nvcc`` into its own shared library under
``kyverno_tpu_torch/_build/`` (named by a digest of the source, the
``csrc/*.cuh`` headers it includes and the flags, so an edited source or
header never loads a stale build), then bound with ``ctypes``.  ``build_all`` compiles every source at once, one ``nvcc``
process per file, so the build costs the slowest file, not the sum.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

#: compile flags: sm_90a (Hopper, with its arch-specific features), no
#: fast-math; -Xptxas -v leaves register/spill counts in the build log
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: kernel name -> (C symbol, ctypes argtypes)
_P = ctypes.c_void_p
KERNELS: Dict[str, tuple] = {
    'k1_vm': ('k1_vm', (
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
        _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P)),
    'k1h_fdet_select': ('k1h_fdet_select', (
        _P, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P,
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)),
    'k1c_wildcard': ('k1c_wildcard', (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p)),
    'k3_mutate': ('k3_mutate', (
        _P, ctypes.POINTER(ctypes.c_longlong), _P, _P, _P, _P, _P, _P, _P,
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, _P)),
    'k4_status_hist': ('k4_status_hist', (
        _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = [os.path.join(home, 'bin', 'nvcc')] if home else []
    which = shutil.which('nvcc')
    if which:
        cands.append(which)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'build on a machine with the CUDA toolkit')


def _source(name: str) -> str:
    return os.path.join(CSRC, f'{name}.cu')


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str, csrc: str = CSRC) -> list:
    """The source of kernel ``name`` and every header under ``csrc`` it
    includes, directly or through another header, in include order."""
    out, todo = [], [os.path.join(csrc, f'{name}.cu')]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path, 'rb') as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(csrc, inc.decode())
                if os.path.isfile(dep):
                    todo.append(dep)
    return out


def library_path(name: str, csrc: str = CSRC) -> str:
    """The build of ``name``, named by a digest of its source, the
    headers it includes and the flags."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources(name, csrc):
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' +
                          f.read())
    return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def _start(name: str, nvcc: str) -> Optional[tuple]:
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
    log = open(os.path.join(BUILD_DIR, f'{name}.log'), 'w')
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', tmp, _source(name)],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) in parallel; returns the
    wall seconds each build took (0.0 for one already built)."""
    names = list(names) if names is not None else list(KERNELS)
    nvcc = nvcc_path()
    t0 = time.monotonic()
    with _lock:
        jobs = {n: _start(n, nvcc) for n in names}
        took: Dict[str, float] = {}
        failed = []
        for n, job in jobs.items():
            if job is None:
                took[n] = 0.0
                continue
            proc, tmp, out, log = job
            rc = proc.wait()
            log.close()
            took[n] = time.monotonic() - t0
            if rc != 0:
                failed.append(n)
                continue
            os.replace(tmp, out)
        if failed:
            msgs = []
            for n in failed:
                with open(os.path.join(BUILD_DIR, f'{n}.log')) as f:
                    msgs.append(f'{n}:\n{f.read()[-4000:]}')
            raise RuntimeError('nvcc failed for ' + ', '.join(failed) +
                               '\n' + '\n'.join(msgs))
    return took


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas
    register and spill counts)."""
    path = os.path.join(BUILD_DIR, f'{name}.log')
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            symbol, argtypes = KERNELS[name]
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib
