"""Digest-keyed verdict cache: in-memory LRU front + atomic on-disk
snapshots.

One **generation** per (policy-set fingerprint × engine rev) holds
``spec digest → verdict row`` where a row is the fused report-path
output of one resource (``BatchScanner.scan_report_results``): the
result dicts (timestamps stripped — replay stamps the current tick),
the summary, and the indexes of the contributing policies (the
fingerprint pins policy-set order, so indexes are stable across
processes).  Rescans replay hit rows in O(1) instead of re-evaluating
the resource×rule matrix; only digests that changed ship to the device.

Persistence reuses the ``aotcache/store.py`` protocol: one snapshot
file per generation (``<fingerprint>-<rev>.vrows``), written
tmp-file + ``os.replace`` so readers never observe a partial snapshot,
framed with a magic + SHA-256 header so a torn or bit-flipped file is
deleted and reloaded as empty — a bad snapshot costs a rescan, never a
crash or a stale verdict.  Disk eviction is LRU by mtime against a
byte budget; the memory front is an entry-capped LRU.

Knobs:

* ``KTPU_VERDICT_CACHE`` — ``0``/``off`` disables the cache entirely
  (default on); the dense full scan is always the correctness oracle.
* ``KTPU_VERDICT_CACHE_DIR`` — snapshot directory (default
  ``<repo>/.cache/verdicts``; empty string keeps the cache
  memory-only).
* ``KTPU_VERDICT_CACHE_MAX`` — on-disk byte budget, default 256 MiB.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from .. import faults
from .keys import engine_rev, generation_key

_log = logging.getLogger('kyverno.verdictcache')

#: snapshot framing: magic + 32-byte SHA-256 of the payload, then payload
_MAGIC = b'KTVC1\n'
_DIGEST_LEN = 32
_SUFFIX = '.vrows'

VERDICT_CACHE_HITS = 'kyverno_tpu_verdict_cache_hits_total'
VERDICT_CACHE_MISSES = 'kyverno_tpu_verdict_cache_misses_total'
VERDICT_CACHE_EVICTIONS = 'kyverno_tpu_verdict_cache_evictions_total'
RESCAN_ROWS_SCANNED = 'kyverno_tpu_rescan_rows_scanned'
RESCAN_ROWS_REPLAYED = 'kyverno_tpu_rescan_rows_replayed'

_DEFAULT_MAX_BYTES = 256 << 20
#: memory-front entry cap (rows are a few hundred bytes; 2M entries is
#: the 1M-Pod steady state with headroom, bounded without a knob)
_MEM_MAX_ENTRIES = 2_000_000


def _reg():
    from ..observability.metrics import global_registry
    return global_registry()


def publish_tick(scanned: int, replayed: int) -> None:
    """Per-tick rescan gauges: how many rows the last reconcile shipped
    to the device vs replayed from the cache (no-op unconfigured)."""
    reg = _reg()
    if reg is None:
        return
    reg.set_gauge(RESCAN_ROWS_SCANNED, float(scanned))
    reg.set_gauge(RESCAN_ROWS_REPLAYED, float(replayed))


def _env_enabled() -> bool:
    return os.environ.get('KTPU_VERDICT_CACHE', '1') not in ('0', 'off')


def _env_root() -> Optional[str]:
    root = os.environ.get(
        'KTPU_VERDICT_CACHE_DIR',
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), '.cache', 'verdicts'))
    return root or None


def _env_max_bytes() -> int:
    try:
        return int(os.environ.get('KTPU_VERDICT_CACHE_MAX',
                                  str(_DEFAULT_MAX_BYTES)))
    except ValueError:
        return _DEFAULT_MAX_BYTES


class VerdictCache:
    """One generation of digest-keyed verdict rows.

    Row schema (JSON-stable): ``{'u': uid, 'r': [result dicts, no
    timestamp key], 's': summary, 'p': [policy indexes]}``.
    """

    def __init__(self, fingerprint: str, root: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 max_entries: int = _MEM_MAX_ENTRIES,
                 rev: Optional[str] = None):
        self.fingerprint = fingerprint
        self.rev = rev or engine_rev()
        self.max_bytes = _env_max_bytes() if max_bytes is None else max_bytes
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._rows: 'OrderedDict[str, dict]' = OrderedDict()
        self._by_uid: Dict[str, Set[str]] = {}
        self._dirty = False
        # local lookup outcome counters: benchmarks and the decision-
        # provenance cross-checks read them without a metrics registry
        self._hits = 0
        self._misses = 0
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError:
                root = None
        self.root = root
        self._load()

    @classmethod
    def from_env(cls, fingerprint: str) -> Optional['VerdictCache']:
        """The env-configured cache, or None when KTPU_VERDICT_CACHE is
        off (callers then run every row through the dense scan)."""
        if not _env_enabled():
            return None
        root = _env_root()
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError:
                root = None
        return cls(fingerprint, root=root)

    def path(self) -> Optional[str]:
        if self.root is None:
            return None
        return os.path.join(
            self.root, generation_key(self.fingerprint, self.rev) + _SUFFIX)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # -- lookups -----------------------------------------------------------

    def lookup(self, digest: str) -> Optional[dict]:
        """The cached row for one spec digest, or None (miss).  Hits
        refresh the memory-LRU position; both outcomes count."""
        with self._lock:
            row = self._rows.get(digest)
            if row is not None:
                self._rows.move_to_end(digest)
                self._hits += 1
            else:
                self._misses += 1
        reg = _reg()
        if reg is not None:
            if row is None:
                reg.inc(VERDICT_CACHE_MISSES)
            else:
                reg.inc(VERDICT_CACHE_HITS)
        return row

    def peek(self, digest: str) -> Optional[dict]:
        """``lookup`` without outcome accounting: composite caches
        (``verdictcache/partitioned.py``) probe every member generation
        per digest but count ONE hit or miss for the whole lookup —
        per-member counting would inflate the metrics by the partition
        count.  Refreshes the LRU position like a real hit."""
        with self._lock:
            row = self._rows.get(digest)
            if row is not None:
                self._rows.move_to_end(digest)
            return row

    # -- writes ------------------------------------------------------------

    def store(self, digest: str, uid: str, results: List[dict],
              summary: dict, policy_indexes: List[int]) -> None:
        """Record one scanned row.  ``results`` are the shared fused-path
        flyweight dicts — never mutated; the stored copies drop the
        ``timestamp`` key so replay can stamp the replaying tick."""
        row = {
            'u': uid,
            'r': [{k: v for k, v in r.items() if k != 'timestamp'}
                  for r in results],
            's': dict(summary),
            'p': list(policy_indexes),
        }
        evicted = 0
        with self._lock:
            old = self._rows.get(digest)
            if old is not None:
                self._unindex(digest, old)
            self._rows[digest] = row
            self._rows.move_to_end(digest)
            self._by_uid.setdefault(uid, set()).add(digest)
            while len(self._rows) > self.max_entries:
                d, dropped = self._rows.popitem(last=False)
                self._unindex(d, dropped)
                evicted += 1
            self._dirty = True
        reg = _reg()
        if evicted and reg is not None:
            reg.inc(VERDICT_CACHE_EVICTIONS, float(evicted))

    def invalidate_uid(self, uid: str) -> int:
        """Drop every entry recorded for ``uid`` (resource changed or
        deleted — a recreated resource with a stale uid must never
        replay old verdicts).  Returns the number dropped."""
        with self._lock:
            digests = self._by_uid.pop(uid, None)
            if not digests:
                return 0
            dropped = 0
            for d in digests:
                if self._rows.pop(d, None) is not None:
                    dropped += 1
            if dropped:
                self._dirty = True
        return dropped

    def _unindex(self, digest: str, row: dict) -> None:
        digests = self._by_uid.get(row.get('u', ''))
        if digests is not None:
            digests.discard(digest)
            if not digests:
                self._by_uid.pop(row.get('u', ''), None)

    # -- replay ------------------------------------------------------------

    def replay(self, row: dict, policies, ts: int
               ) -> Tuple[List[dict], dict, list]:
        """Row → the ``(results, summary, row_policies)`` triple
        ``scan_report_results`` would yield, stamped with ``ts`` (all
        results of one fused row share the tick's timestamp, so sort
        order is unaffected).

        Re-stamping is lazy: the stamped form is written back onto the
        row with the tick second it carries, so replays within the same
        second (fast reconcile loops over a large cache) return the
        shared dicts with zero per-result copies.  Stamped results are
        immutable from then on — a later tick with a different second
        builds fresh copies, never mutating what an earlier report may
        still reference."""
        if row.get('t') == ts:
            results = row['r']
        else:
            stamp = {'seconds': ts}
            results = [dict(r, timestamp=stamp) for r in row['r']]
            row['r'] = results
            row['t'] = ts
        return (results, dict(row['s']),
                [policies[p] for p in row['p'] if p < len(policies)])

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        """Populate the memory front from this generation's snapshot.
        A short, unframed, digest-mismatched, or undecodable snapshot
        is deleted and loaded as empty — never raised."""
        path = self.path()
        if path is None or not os.path.exists(path):
            return
        try:
            # an injected verdict_snapshot_read fault degrades exactly
            # like an unreadable file: load as empty, rescan refills
            faults.check(faults.SITE_VERDICT_SNAPSHOT)
            with open(path, 'rb') as f:
                raw = f.read()
        except Exception:  # noqa: BLE001 - unreadable snapshot: empty
            return
        header = len(_MAGIC) + _DIGEST_LEN
        payload = raw[header:]
        if (len(raw) < header or not raw.startswith(_MAGIC) or
                hashlib.sha256(payload).digest() != raw[len(_MAGIC):header]):
            _log.warning('verdict snapshot %s corrupt; dropping',
                         os.path.basename(path))
            self._drop_file(path)
            return
        try:
            rows = json.loads(zlib.decompress(payload).decode())
        except Exception:  # noqa: BLE001 - stale codec decodes as empty
            self._drop_file(path)
            return
        with self._lock:
            for digest, row in rows.items():
                self._rows[digest] = row
                self._by_uid.setdefault(row.get('u', ''), set()).add(digest)
            while len(self._rows) > self.max_entries:
                d, dropped = self._rows.popitem(last=False)
                self._unindex(d, dropped)
        try:
            os.utime(path)  # disk LRU works off mtime, like the AOT store
        except OSError:
            pass

    @staticmethod
    def _drop_file(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def flush(self) -> bool:
        """Atomically persist this generation's rows (tmp + rename) when
        dirty, then evict older generation snapshots LRU-by-mtime to fit
        the byte budget.  Returns True when a snapshot was written."""
        path = self.path()
        if path is None:
            return False
        with self._lock:
            if not self._dirty:
                return False
            payload = zlib.compress(json.dumps(
                self._rows, separators=(',', ':')).encode(), 3)
            self._dirty = False
        framed = _MAGIC + hashlib.sha256(payload).digest() + payload
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix='.tmp')
            try:
                with os.fdopen(fd, 'wb') as f:
                    f.write(framed)
                os.replace(tmp, path)
            except BaseException:
                self._drop_file(tmp)
                raise
        except OSError:
            return False
        self._evict_disk(keep=path)
        return True

    def _evict_disk(self, keep: str) -> None:
        """Drop oldest generation snapshots until the directory fits the
        budget (the just-written snapshot always survives)."""
        entries = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            p = os.path.join(self.root, name)
            if name.endswith('.tmp'):
                try:  # orphaned partial writes from killed processes
                    if time.time() - os.stat(p).st_mtime > 600:
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
            entries.append((st.st_mtime, st.st_size, p))
        entries.sort()
        total = sum(sz for _, sz, _ in entries)
        evicted = 0
        for _, sz, p in entries:
            if total <= self.max_bytes or p == keep:
                continue
            try:
                os.unlink(p)
                total -= sz
                evicted += 1
            except OSError:
                pass
        reg = _reg()
        if evicted and reg is not None:
            reg.inc(VERDICT_CACHE_EVICTIONS, float(evicted))

    def stats(self) -> Dict[str, int]:
        path = self.path()
        size = 0
        if path is not None:
            try:
                size = os.stat(path).st_size
            except OSError:
                size = 0
        with self._lock:
            return {'entries': len(self._rows), 'snapshot_bytes': size,
                    'hits': self._hits, 'misses': self._misses}
