"""Disk-backed AOT blob store: atomic, corruption-tolerant, size-capped.

One entry per cache key (``<key>.aotexe``), written with the
tmp-file + ``os.replace`` protocol so readers never observe a partial
entry, framed with a magic + SHA-256 header so a torn or bit-flipped
entry is detected, deleted, and reported as a miss — a bad entry can
cost a recompile, never a crash or a wrong executable.  Eviction is
LRU by mtime (loads touch their entry) against a byte budget.

Knobs:

* ``KTPU_AOT`` — ``0`` disables the store entirely (default on).
* ``KTPU_AOT_CACHE_DIR`` — cache directory (legacy spelling
  ``KTPU_AOT_CACHE`` still honoured; default ``<repo>/.cache/aot``).
* ``KTPU_AOT_CACHE_MAX`` — byte budget, default 8 GiB.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

_log = logging.getLogger('kyverno.aotcache')

#: entry framing: magic + 32-byte SHA-256 of the payload, then payload
_MAGIC = b'KTAC1\n'
_DIGEST_LEN = 32

_SUFFIX = '.aotexe'
#: pre-subsystem entries (never valid now: different framing + codec)
_LEGACY_SUFFIXES = ('.exe.zst',)

AOT_CACHE_SIZE_BYTES = 'kyverno_tpu_aot_cache_size_bytes'
AOT_CACHE_ENTRIES = 'kyverno_tpu_aot_cache_entries'

_DEFAULT_MAX_BYTES = 8 << 30


def _env_root() -> Optional[str]:
    if os.environ.get('KTPU_AOT', '1') != '1':
        return None
    return (os.environ.get('KTPU_AOT_CACHE_DIR')
            or os.environ.get('KTPU_AOT_CACHE')
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                '.cache', 'aot'))


def _env_max_bytes() -> int:
    try:
        return int(os.environ.get('KTPU_AOT_CACHE_MAX',
                                  str(_DEFAULT_MAX_BYTES)))
    except ValueError:
        return _DEFAULT_MAX_BYTES


class AotStore:
    """One directory of integrity-framed blobs keyed by hex cache key."""

    def __init__(self, root: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self.max_bytes = _env_max_bytes() if max_bytes is None else max_bytes
        self._lock = threading.Lock()
        if root is None:
            root = _env_root()
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError:
                root = None
        self.root = root

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def path(self, key: str) -> Optional[str]:
        if self.root is None:
            return None
        return os.path.join(self.root, f'{key}{_SUFFIX}')

    # -- reads ------------------------------------------------------------

    def load(self, key: str) -> Optional[bytes]:
        """The entry's payload, or None (miss).  A short, unframed, or
        digest-mismatched entry is deleted and reported as a miss."""
        path = self.path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, 'rb') as f:
                raw = f.read()
        except OSError:
            return None
        header = len(_MAGIC) + _DIGEST_LEN
        payload = raw[header:]
        if (len(raw) < header or not raw.startswith(_MAGIC) or
                hashlib.sha256(payload).digest() !=
                raw[len(_MAGIC):header]):
            _log.warning('aot cache entry %s corrupt; dropping', key[:12])
            self.delete(key)
            return None
        try:
            os.utime(path)  # LRU eviction works off mtime
        except OSError:  # a touch failure must not void a good load
            pass
        return payload

    # -- writes -----------------------------------------------------------

    def put(self, key: str, payload: bytes) -> bool:
        """Atomically persist one entry, evicting LRU entries first so
        the directory stays within the byte budget."""
        path = self.path(key)
        if path is None:
            return False
        framed = _MAGIC + hashlib.sha256(payload).digest() + payload
        try:
            with self._lock:
                self._evict(budget=self.max_bytes - len(framed))
                fd, tmp = tempfile.mkstemp(dir=self.root, suffix='.tmp')
                try:
                    with os.fdopen(fd, 'wb') as f:
                        f.write(framed)
                    os.replace(tmp, path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
        except OSError:
            return False
        publish_stats(self)
        return True

    def delete(self, key: str) -> None:
        path = self.path(key)
        if path is None:
            return
        try:
            os.unlink(path)
        except OSError:
            return
        publish_stats(self)

    # -- bookkeeping ------------------------------------------------------

    def _entries(self) -> List[Tuple[float, int, str]]:
        """(mtime, size, path) per live entry; prunes stale tmp files
        and legacy-format entries on the way."""
        out: List[Tuple[float, int, str]] = []
        if self.root is None:
            return out
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            p = os.path.join(self.root, name)
            if name.endswith('.tmp'):
                # orphaned partial writes from killed processes — the
                # atomic-rename protocol never leaves a fresh .tmp
                # behind for long, so stale ones are garbage
                try:
                    if time.time() - os.stat(p).st_mtime > 600:
                        os.unlink(p)
                except OSError:
                    pass
                continue
            if name.endswith(_LEGACY_SUFFIXES):
                try:
                    os.unlink(p)
                except OSError:
                    pass
                continue
            if not name.endswith(_SUFFIX):
                continue
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, p))
        return out

    def _evict(self, budget: int) -> None:
        """Drop oldest entries until the directory fits the budget."""
        entries = sorted(self._entries())
        total = sum(sz for _, sz, _ in entries)
        for _, sz, p in entries:
            if total <= max(budget, 0):
                break
            try:
                os.unlink(p)
                total -= sz
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        entries = self._entries()
        return {'entries': len(entries),
                'bytes': sum(sz for _, sz, _ in entries)}


# -- process-global default store -------------------------------------------

_DEFAULT: Optional[AotStore] = None
_DEFAULT_LOCK = threading.Lock()


def default_store() -> AotStore:
    """The env-configured store shared by every jit site.  Stable for
    the process; ``reset_default_store`` re-reads the environment
    (tests flip ``KTPU_AOT_CACHE_DIR`` between cases)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = AotStore()
        return _DEFAULT


def reset_default_store() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None


def publish_stats(store: Optional[AotStore] = None) -> None:
    """Push the store's entry/byte gauges to the configured registry
    (no-op in unconfigured processes)."""
    from ..observability.metrics import global_registry
    reg = global_registry()
    if reg is None:
        return
    st = (store or default_store()).stats()
    # ktpu: noqa[KTPU603] -- cache bytes describe the on-disk store,
    # which outlives the process; the last sample stays true after a
    # drain, so reset-on-close would be wrong here
    reg.set_gauge(AOT_CACHE_SIZE_BYTES, float(st['bytes']))
    # ktpu: noqa[KTPU603] -- same as above: entry count is persistent
    # store state, not live process occupancy
    reg.set_gauge(AOT_CACHE_ENTRIES, float(st['entries']))
