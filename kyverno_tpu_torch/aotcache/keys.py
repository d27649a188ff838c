"""Cache-key derivation for persisted K1v programs + the nvcc library
directory hookup.

A stored K1v program (``ops/vm.py Program``) is only valid where its
meaning still holds, so the key covers every axis that changes what the
lowering produces or what the kernel makes of it: the policy-set
fingerprint, the digest of the lowering's, the evaluator's and the
interpreter's sources, the torch and CUDA versions, the card's name and
compute capability, the host CPU feature set, and the pack layout
signature (buffer names, dtypes and widths — not the row count).
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

#: bump to invalidate every persisted program (framing/codec changes)
AOT_VERSION = 1

#: the sources whose meaning a stored K1v program carries: the compiler
#: that makes its IR and everything it reads (the policy model, autogen,
#: the engine's pattern and operator semantics, quantities and
#: durations), the evaluator and the lowering (``ops/vm.py``, whose
#: settings such as ``STAGE_BYTES``, ``GROUP_WARPS`` and ``TILE_ROWS`` the
#: key also holds at their current values), and the interpreter that
#: runs it
SOURCE_DIRS = ('api', 'autogen', 'compiler', 'engine', 'ops', 'utils')
KERNEL_SOURCES = ('csrc/k1_vm.cu', 'csrc/k1_vm.cuh', 'csrc/glob_dp.cuh')

_SOURCE_DIGEST: Optional[str] = None


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def source_files() -> List[str]:
    """Every module under ``SOURCE_DIRS`` (sorted), then
    ``KERNEL_SOURCES``: paths relative to the package."""
    base = _package_dir()
    found = []
    for top in SOURCE_DIRS:
        for dirpath, _dirs, files in os.walk(os.path.join(base, top)):
            found += [os.path.relpath(os.path.join(dirpath, f), base)
                      for f in files if f.endswith('.py')]
    return sorted(found) + list(KERNEL_SOURCES)


def source_digest() -> str:
    """Digest of ``source_files()``: any change to them invalidates AOT
    entries (the program bakes in their semantics)."""
    global _SOURCE_DIGEST
    if _SOURCE_DIGEST is None:
        h = hashlib.sha256()
        base = _package_dir()
        for rel in source_files():
            h.update(rel.encode() + b'\0')
            try:
                with open(os.path.join(base, rel), 'rb') as f:
                    h.update(f.read())
            except OSError:
                pass
        _SOURCE_DIGEST = h.hexdigest()[:16]
    return _SOURCE_DIGEST


def policy_semantics(doc: dict) -> tuple:
    """What the engine reads of a stored policy document: its
    ``apiVersion``, ``kind``, ``spec`` and of its metadata the
    namespace, name, labels and annotations (``api/policy.py`` reads the
    name, namespace and annotations).  Not its ``status``, which the
    webhook reconciler writes, nor the stamps the API server sets on
    each write (``resourceVersion``, ``generation``, ``uid``,
    ``creationTimestamp``, ``managedFields``, ``selfLink``)."""
    meta = doc.get('metadata') or {}
    return (doc.get('apiVersion'), doc.get('kind'), meta.get('namespace'),
            meta.get('name'), meta.get('labels'), meta.get('annotations'),
            doc.get('spec'))


def policy_set_fingerprint(policies) -> str:
    """Stable digest of a policy set's ``policy_semantics`` (the K1v
    programs and the verdict rows are a deterministic function of them
    — verified cross-process).

    Unlike the JAX package's key, which digests the whole raw documents,
    a status write or a server stamp leaves this fingerprint as it was:
    a daemon restarted after its reconciler wrote status loads its
    programs and replays its verdict rows instead of lowering and
    rescanning."""
    import json
    payload = json.dumps(
        [policy_semantics(getattr(p, 'raw', p)) for p in policies],
        sort_keys=True, separators=(',', ':'), default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:20]


def host_fingerprint() -> str:
    """Short hash of the host CPU feature set.  XLA:CPU AOT artifacts
    embed the compile machine's features and can SIGILL when loaded on a
    host missing them; scoping the cache dir per feature set keeps a
    shared checkout safe across heterogeneous machines."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('flags'):
                    return hashlib.sha256(
                        ' '.join(sorted(line.split())).encode()
                    ).hexdigest()[:10]
    except OSError:
        pass
    import platform
    return hashlib.sha256(platform.machine().encode()).hexdigest()[:10]


def initialized_platforms() -> Tuple[str, ...]:
    """``('cuda',)`` once this process has initialized CUDA, else
    ``('cpu',)``.  Asking creates no CUDA context."""
    return ('cuda',) if torch.cuda.is_initialized() else ('cpu',)


def _device_identity() -> Tuple:
    """The current card's name and compute capability, read only where
    CUDA is already initialized (``device.py``'s rule: nothing here
    creates a CUDA context, so a caller may still fork workers)."""
    if not torch.cuda.is_initialized():
        return ()
    idx = torch.cuda.current_device()
    return (torch.cuda.get_device_name(idx),
            tuple(torch.cuda.get_device_capability(idx)))


def env_scope() -> Tuple:
    """The environment a stored program is only valid under: host CPU
    features, the torch and CUDA versions, the live platforms and the
    card."""
    return (host_fingerprint(), torch.__version__, torch.version.cuda,
            initialized_platforms(), _device_identity())


def _distributed_world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def executable_cache_key(fingerprint: str, packed: Dict[str, Any],
                         extra: Tuple = ()) -> Optional[str]:
    """Cache key for one (policy set, pack layout, environment) combo.

    The layout signature is each buffer's name, dtype and widths
    **without the row count**: one K1v program serves every row count
    of its layout (``ops/eval.py plan_for``), so unlike an XLA
    executable's key this one does not change with the batch capacity.

    Returns None when the entry must not be persisted or loaded:

    * under a ``torch.distributed`` group of world size above 1 (the
      mesh path: its programs are built per rank, as the JAX key
      refuses sharded inputs);
    * under ``KTPU_AOT=0``;
    * on any exception (the cache is an optimization only).
    """
    try:
        if os.environ.get('KTPU_AOT', '1') != '1':
            return None
        if _distributed_world() > 1:
            return None
        sig = [(name, str(v.dtype), tuple(v.shape[1:]))
               for name, v in sorted(packed.items())]
        payload = repr((AOT_VERSION, source_digest(), fingerprint, sig,
                        env_scope(), extra))
        return hashlib.sha256(payload.encode()).hexdigest()[:32]
    except Exception:  # noqa: BLE001 - cache is an optimization only
        return None


# -- the nvcc library directory ---------------------------------------------

#: counted when the feature guard refuses a cache directory (same
#: series the AOT executable store uses for its load rejections)
AOT_LOAD_REJECTED = 'kyverno_tpu_aot_load_rejected_total'

#: marker file recording which host CPU feature set populated a
#: persistent-cache directory
HOSTKEY_FILE = 'HOSTKEY'


def verify_cache_feature_scope(cache_dir: str) -> Tuple[str, bool]:
    """Feature guard for a persistent cache directory.

    An operator-pinned ``KTPU_COMPILE_CACHE`` may be shared across
    heterogeneous machines, and what one host built is not trusted on
    another.  A ``HOSTKEY`` marker records which feature set populated
    the directory; on mismatch the dir is re-scoped to a
    ``feat-<digest>`` subdirectory and the rejection counts on
    ``kyverno_tpu_aot_load_rejected_total{reason=feature_mismatch}``.
    Returns ``(usable_dir, rejected)``."""
    fp = host_fingerprint()
    marker = os.path.join(cache_dir, HOSTKEY_FILE)
    recorded: Optional[str] = None
    try:
        with open(marker) as f:
            recorded = f.read().strip()
    except OSError:
        pass
    if recorded is not None and recorded != fp:
        from ..observability.metrics import global_registry
        registry = global_registry()
        if registry is not None:
            registry.inc(AOT_LOAD_REJECTED, reason='feature_mismatch')
        cache_dir = os.path.join(cache_dir, f'feat-{fp}')
        rejected = True
    else:
        rejected = False
    if recorded != fp:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with open(os.path.join(cache_dir, HOSTKEY_FILE), 'w') as f:
                f.write(fp)
        except OSError:
            pass
    return cache_dir, rejected


def enable_persistent_compilation_cache() -> Optional[str]:
    """The port's counterpart of XLA's persistent compilation cache is
    the kernels' library directory: ``ops/_build.py`` builds into
    ``KTPU_COMPILE_CACHE`` when that is set (past the feature guard
    above), so a fresh process loads the ``nvcc`` builds of an earlier
    one, and into ``kyverno_tpu_torch/_build/`` otherwise.  Returns the
    directory in use, or None when it cannot be made."""
    from ..ops import _build
    try:
        return _build.build_dir()
    except OSError:
        return None
