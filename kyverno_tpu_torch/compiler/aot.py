"""AOT program codec: K1v programs to/from the persistent store.

The port's counterpart of a compiled XLA executable is K1v's bytecode
for one (evaluator, pack layout): a :class:`kyverno_tpu_torch.ops.vm.
Program`, numpy tables and a launch plan.  Lowering it costs a fraction
of a second per layout, and a fresh process that finds it in the store
keyed by :func:`kyverno_tpu_torch.aotcache.keys.executable_cache_key`
serves device scans with zero lowerings for a cached policy set.

Blobs are ``codec byte + compressed pickle((state, meta))``; zstandard
when available, stdlib zlib otherwise.  ``state`` is the program's
attributes without two: ``_dev``, its per-device CUDA tables (a loaded
program uploads its own), and ``plain``, the closure over its evaluator
that ``ops/eval.py LayoutPlan`` attaches again after a load.  ``meta``
records the store-time environment (host CPU-feature fingerprint, env
scope, torch and CUDA versions); the key already scopes on these axes,
but the load path re-checks the recorded meta and REJECTS mismatched
entries (a fresh lowering instead), counting each rejection on
``kyverno_tpu_aot_load_rejected_total{reason}``.  Integrity framing and
eviction live one layer down in
:class:`kyverno_tpu_torch.aotcache.store.AotStore` — a corrupt or
stale-codec entry decodes as a miss and is dropped, never raised.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
from typing import Any, Optional, Tuple

from ..aotcache import keys as _keys
from ..aotcache.keys import executable_cache_key  # noqa: F401 (re-export)
from ..aotcache.store import AotStore, default_store

_log = logging.getLogger('kyverno.aotcache')

AOT_LOAD_REJECTED = 'kyverno_tpu_aot_load_rejected_total'

_CODEC_ZSTD = b'Z'
_CODEC_ZLIB = b'D'


def _zstd():
    try:
        import zstandard
        return zstandard
    except ImportError:
        return None


def _torch_versions() -> Tuple[str, Optional[str]]:
    import torch
    return (torch.__version__, torch.version.cuda)


def _compile_meta() -> dict:
    """The environment axes a program is only loadable under."""
    return {
        'host_features': _keys.host_fingerprint(),
        'env_scope': repr(_keys.env_scope()),
        'torch': _torch_versions(),
    }


#: attributes of a Program that are not part of what is stored
_UNSTORED = ('_dev', 'plain')


def encode_executable(program) -> bytes:
    """K1v program → compressed blob (raises on failure)."""
    state = {k: v for k, v in vars(program).items() if k not in _UNSTORED}
    return _pack_blob(state, _compile_meta())


def _pack_blob(state: dict, meta: dict) -> bytes:
    raw = pickle.dumps((state, meta))
    zstd = _zstd()
    if zstd is not None:
        return _CODEC_ZSTD + zstd.ZstdCompressor(level=3).compress(raw)
    import zlib
    return _CODEC_ZLIB + zlib.compress(raw, 3)


def _unpack_blob(blob: bytes) -> Tuple[dict, dict]:
    """blob → (state, meta); raises on any codec or framing mismatch
    (callers treat that as ``undecodable``)."""
    codec, body = blob[:1], blob[1:]
    if codec == _CODEC_ZSTD:
        import zstandard
        raw = zstandard.ZstdDecompressor().decompress(body)
    elif codec == _CODEC_ZLIB:
        import zlib
        raw = zlib.decompress(body)
    else:
        raise ValueError(f'unknown aot codec {codec!r}')
    state, meta = pickle.loads(raw)
    if not isinstance(state, dict):
        raise ValueError('aot frame without a program state')
    return state, meta


def _meta_mismatch(meta: dict) -> Optional[str]:
    """Rejection reason when ``meta`` does not match this process."""
    current = {
        'host_features': ('feature_mismatch', _keys.host_fingerprint()),
        'env_scope': ('env_mismatch', repr(_keys.env_scope())),
        'torch': ('torch_mismatch', _torch_versions()),
    }
    for field, (reason, want) in current.items():
        got = meta.get(field)
        if got is None:
            continue  # older frame missing this axis: key scoping holds
        if isinstance(want, tuple):
            got = tuple(got)
        if got != want:
            return reason
    return None


def _program(state: dict):
    """The Program of a stored ``state``, with empty device tables and
    no plain version (its evaluator attaches one); raises when the state
    lacks a table the launch reads."""
    from ..ops.vm import Program
    missing = [k for k in ('code', 'lanes', 'i64', 'f64', 'bytes',
                           'warps', 'groups', 'layout') if k not in state]
    if missing:
        raise ValueError(f'stored program lacks {missing}')
    program = Program.__new__(Program)
    program.__dict__.update(state)
    program._dev = {}
    return program


def decode_executable(blob: bytes) -> Any:
    """blob → loaded program (raises on any mismatch — callers treat
    that as a miss and drop the entry)."""
    state, _meta = _unpack_blob(blob)
    return _program(state)


# -- store orchestration ------------------------------------------------------

def _count_rejection(reason: str) -> None:
    from ..observability.metrics import global_registry
    reg = global_registry()
    if reg is not None:
        reg.inc(AOT_LOAD_REJECTED, reason=reason)


def _reject(store: AotStore, key: str, reason: str) -> None:
    """Drop an unloadable entry and account for it: the caller falls
    back to a fresh compile (persistent-XLA-cache assisted), which is
    always safe — a forced load of a feature-mismatched executable can
    SIGILL the process."""
    from ..observability import executables
    _log.warning('aot entry %s rejected at load (%s); dropping',
                 key[:12], reason)
    store.delete(key)
    _count_rejection(reason)
    executables.record_eviction(key, reason)


def load_executable(key: str, store: Optional[AotStore] = None) -> Any:
    """Loaded K1v program for ``key`` or None.  A blob that fails to
    decode (a stale codec, a torn write below the framing's
    resolution), was stored under another CPU-feature set, environment
    or torch build, or does not make a program is deleted and counted
    on ``aot_load_rejected_total`` so the next process lowers afresh
    instead of re-failing."""
    from .. import faults
    store = store or default_store()
    blob = store.load(key)
    if blob is None:
        return None
    try:
        # injected aot_load faults exercise the real rejection path: a
        # load that dies mid-decode counts a rejection and recompiles
        faults.check(faults.SITE_AOT_LOAD)
        state, meta = _unpack_blob(blob)
    except Exception:  # noqa: BLE001 - stale/corrupt entry: recompile
        _reject(store, key, 'undecodable')
        return None
    reason = _meta_mismatch(meta if isinstance(meta, dict) else {})
    if reason is not None:
        _reject(store, key, reason)
        return None
    try:
        return _program(state)
    except Exception:  # noqa: BLE001 - not a program of this build
        _reject(store, key, 'deserialize_failed')
        return None


#: in-flight background stores; flush_stores() joins them (tests, and
#: warmers that want the entry on disk before declaring readiness)
_STORE_THREADS: set = set()
_STORE_THREADS_LOCK = threading.Lock()


def store_executable_async(key: str, program,
                           store: Optional[AotStore] = None) -> None:
    """Serialize + write the K1v ``program`` in a daemon thread
    (must not block the scan path); ``flush_stores`` joins it, which a
    process that exits soon after must call."""
    store = store or default_store()
    if not store.enabled:
        return

    def work():
        try:
            store.put(key, encode_executable(program))
        except Exception:  # noqa: BLE001 - cache write is best-effort
            pass
        finally:
            with _STORE_THREADS_LOCK:
                _STORE_THREADS.discard(threading.current_thread())

    t = threading.Thread(target=work, daemon=True,
                         name=f'aot-store-{key[:8]}')
    with _STORE_THREADS_LOCK:
        _STORE_THREADS.add(t)
    t.start()


def flush_stores(timeout: float = 120.0) -> None:
    """Join outstanding background stores (bounded per thread)."""
    with _STORE_THREADS_LOCK:
        threads = list(_STORE_THREADS)
    for t in threads:
        t.join(timeout)


def evict_executable(key: str, store: Optional[AotStore] = None,
                     reason: Optional[str] = None) -> None:
    """Drop a poisoned entry from disk so the next call lowers afresh.
    ``reason`` (e.g. ``execute_failed`` for a program that loaded but
    whose launch failed) also counts the eviction on
    ``aot_load_rejected_total``."""
    (store or default_store()).delete(key)
    if reason is not None:
        from ..observability import executables
        _count_rejection(reason)
        executables.record_eviction(key, reason)


def warm_cache_dir() -> Optional[str]:
    """The active store directory (diagnostics)."""
    s = default_store()
    return s.root


def aot_enabled() -> bool:
    return default_store().enabled and \
        os.environ.get('KTPU_AOT', '1') == '1'
