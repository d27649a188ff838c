"""Per-partition verdict-cache generations: verdicts survive policy
churn.

The monolithic :class:`~.store.VerdictCache` keys its single generation
by the whole-set fingerprint, so editing ONE policy invalidates every
cached row and the next reconcile re-scans the world.  This composite
keeps one :class:`VerdictCache` generation per partition of the
:mod:`kyverno_tpu.partition` plan, keyed by the **partition**
fingerprint: a policy edit only rolls the generations of the touched
partitions, and the unchanged partitions' rows keep replaying.

Row splitting is exact because the fused report contract is
per-policy: each result dict names its policy
(``results.py:_rule_result`` sets ``result['policy']`` to the policy
key), the summary is a pure bucket count of the results
(``results.py:calculate_summary``), and the contributing-policy
indexes partition by plan assignment.  A stored subrow keeps
partition-**local** policy indexes — the partition fingerprint pins
the member list and its order, so local indexes stay stable while
global indexes shift under add/delete churn elsewhere in the set.

Composition merges the per-partition sorted result lists with the
``sort_report_results`` key (fused rows are device-only when cacheable
— ``controllers.py:_verdicts_cacheable`` — and arrive pre-sorted by
``(policy, rule)``; all results of one row share the tick timestamp),
sums the summaries bucket-wise, and unions the local indexes back to
global.  ``KTPU_PARTITIONS=0`` keeps the monolithic cache as the
bit-identity oracle (pinned by ``tests/test_partition.py``).

The **partial hit** is the churn payoff: when only touched partitions
miss, :meth:`partial` hands the cached unchanged subrows to the
controller, which re-scans the row against a scanner scoped to the
touched partitions' member policies and :meth:`merge_scoped` composes
+ stores the result — O(touched policies) device work per row instead
of O(set).
"""

from __future__ import annotations

import heapq
import os
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from .store import (VERDICT_CACHE_HITS, VERDICT_CACHE_MISSES, VerdictCache,
                    _env_enabled, _env_root)

VERDICT_CACHE_PARTIAL_HITS = 'kyverno_tpu_verdict_cache_partial_hits_total'

_EMPTY_SUMMARY = {'pass': 0, 'fail': 0, 'warn': 0, 'error': 0, 'skip': 0}


def _reg():
    from ..observability.metrics import global_registry
    return global_registry()


def _sort_key(r: dict) -> Tuple[str, str]:
    # the fused-row restriction of results.py:sort_report_results: rows
    # are per-resource (no 'resources' lists) and share one timestamp,
    # so only (policy, rule) discriminates
    return (r.get('policy', ''), r.get('rule', ''))


class PartitionedVerdictCache:
    """One :class:`VerdictCache` generation per plan partition, exposed
    behind the monolithic cache's interface (``lookup`` / ``replay`` /
    ``store`` / ``invalidate_uid`` / ``flush`` / ``stats``) plus the
    scoped-rescan pair ``partial`` / ``merge_scoped``.

    Hit/miss accounting is per whole-row lookup (sub-generations are
    probed with the uncounted ``peek``), so the
    ``kyverno_tpu_verdict_cache_*`` series stay comparable with the
    monolithic cache regardless of the partition count.
    """

    def __init__(self, plan, policies, root: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 prev: Optional['PartitionedVerdictCache'] = None):
        self.plan = plan
        self.root = root
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._partials = 0
        self._parts: Dict[int, VerdictCache] = {}
        self._l2g: Dict[int, List[int]] = {}
        self._g2l: Dict[int, Dict[int, int]] = {}
        self._key_pid: Dict[str, int] = {}
        # carry the predecessor's sub-caches for partitions whose
        # fingerprint survived the churn: in memory-only mode this IS
        # the replay-across-churn property (there is no snapshot to
        # reload); with a root it just skips a redundant reload
        prev_by_fp: Dict[str, VerdictCache] = {}
        if prev is not None:
            for sub in prev._parts.values():
                prev_by_fp[sub.fingerprint] = sub
        for part in plan.partitions:
            sub = prev_by_fp.get(part.fingerprint)
            if sub is None or sub.root != root:
                sub = VerdictCache(part.fingerprint, root=root,
                                   max_bytes=max_bytes)
            self._parts[part.pid] = sub
            l2g = list(part.policy_indices)
            self._l2g[part.pid] = l2g
            self._g2l[part.pid] = {g: loc for loc, g in enumerate(l2g)}
            for g in l2g:
                self._key_pid[policies[g].get_kind_and_name()] = part.pid

    @classmethod
    def from_env(cls, plan, policies,
                 prev: Optional['PartitionedVerdictCache'] = None
                 ) -> Optional['PartitionedVerdictCache']:
        """Env-gated exactly like :meth:`VerdictCache.from_env` (same
        ``KTPU_VERDICT_CACHE`` / ``_DIR`` / ``_MAX`` knobs — partition
        generations share the snapshot directory and byte budget)."""
        if not _env_enabled():
            return None
        root = _env_root()
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError:
                root = None
        return cls(plan, policies, root=root, prev=prev)

    def __len__(self) -> int:
        # sub-generations store in lockstep; LRU/invalidations can skew
        # them, so the largest is the honest upper bound
        return max((len(s) for s in self._parts.values()), default=0)

    # -- lookups -----------------------------------------------------------

    def lookup(self, digest: str) -> Optional[dict]:
        """The composed whole-row for one spec digest, or None.  A hit
        requires EVERY partition generation to hold the digest —
        otherwise the split would silently drop the missing partition's
        results.  Counts one hit or miss total."""
        subs: Dict[int, dict] = {}
        missed = False
        for pid, sub in self._parts.items():
            row = sub.peek(digest)
            if row is None:
                missed = True
                break
            subs[pid] = row
        with self._lock:
            if missed:
                self._misses += 1
            else:
                self._hits += 1
        reg = _reg()
        if reg is not None:
            if missed:
                reg.inc(VERDICT_CACHE_MISSES)
            else:
                reg.inc(VERDICT_CACHE_HITS)
        return None if missed else self._compose(subs)

    def partial(self, digest: str, scoped_pids: FrozenSet[int]
                ) -> Optional[Dict[int, dict]]:
        """After a full-lookup miss: the cached subrows of every
        partition OUTSIDE ``scoped_pids`` — the unchanged half of a
        scoped rescan — or None when any of those also misses (the row
        then takes the dense path).  Uncounted against hit/miss; counts
        on the partial-hit series instead."""
        subs: Dict[int, dict] = {}
        for pid, sub in self._parts.items():
            if pid in scoped_pids:
                continue
            row = sub.peek(digest)
            if row is None:
                return None
            subs[pid] = row
        with self._lock:
            self._partials += 1
        reg = _reg()
        if reg is not None:
            reg.inc(VERDICT_CACHE_PARTIAL_HITS)
        return subs

    def _compose(self, subs: Dict[int, dict]) -> dict:
        """Subrows → one whole-row in the monolithic row schema.  The
        composed row is ephemeral (rebuilt per lookup); ``replay``'s
        lazy stamping writes onto it, never onto the stored subrows."""
        lists = [subs[pid]['r'] for pid in sorted(subs) if subs[pid]['r']]
        if len(lists) == 1:
            merged = list(lists[0])
        else:
            merged = list(heapq.merge(*lists, key=_sort_key))
        summary = dict(_EMPTY_SUMMARY)
        gidx: List[int] = []
        uid = ''
        for pid in sorted(subs):
            row = subs[pid]
            uid = row.get('u') or uid
            for k, v in row['s'].items():
                summary[k] = summary.get(k, 0) + v
            l2g = self._l2g[pid]
            gidx.extend(l2g[loc] for loc in row['p'] if loc < len(l2g))
        return {'u': uid, 'r': merged, 's': summary, 'p': sorted(gidx)}

    # -- replay ------------------------------------------------------------

    def replay(self, row: dict, policies, ts: int
               ) -> Tuple[List[dict], dict, list]:
        """Identical contract to :meth:`VerdictCache.replay`; operates
        on the composed row, so stored subrows stay timestamp-free."""
        if row.get('t') == ts:
            results = row['r']
        else:
            stamp = {'seconds': ts}
            results = [dict(r, timestamp=stamp) for r in row['r']]
            row['r'] = results
            row['t'] = ts
        return (results, dict(row['s']),
                [policies[p] for p in row['p'] if p < len(policies)])

    # -- writes ------------------------------------------------------------

    def store(self, digest: str, uid: str, results: List[dict],
              summary: dict, policy_indexes: List[int]) -> None:
        """Split one whole-row across every partition generation.  Every
        partition stores a subrow — an empty one when none of its
        policies contributed — so a later lookup can tell "partition
        didn't match" from "partition's row was never scanned"."""
        del summary  # recomputed per partition: exact bucket counts
        self._store_split(digest, uid, results, policy_indexes,
                          list(self._parts))

    def _store_split(self, digest: str, uid: str, results: List[dict],
                     global_indexes, pids: List[int]) -> None:
        by_pid: Dict[int, List[dict]] = {pid: [] for pid in pids}
        for r in results:
            target = by_pid.get(self._key_pid.get(r.get('policy', '')))
            if target is not None:
                target.append(r)
        for pid in pids:
            sub_results = by_pid[pid]
            summary = dict(_EMPTY_SUMMARY)
            for r in sub_results:
                s = r.get('result', '')
                if s in summary:
                    summary[s] += 1
            g2l = self._g2l[pid]
            self._parts[pid].store(
                digest, uid, sub_results, summary,
                [g2l[g] for g in global_indexes if g in g2l])

    def merge_scoped(self, digest: str, uid: str, cached: Dict[int, dict],
                     results: List[dict], summary: dict,
                     scoped_global_indexes: List[int], ts: int
                     ) -> Tuple[List[dict], dict, List[int]]:
        """Complete a partial hit: ``results`` came from a scanner
        scoped to the partitions NOT in ``cached`` (the touched ones).
        Stores their split — the digest becomes a full hit from here on
        — and returns the whole-row ``(results, summary,
        global_policy_indexes)`` composed from cache + scoped scan."""
        del summary
        scoped_pids = [pid for pid in self._parts if pid not in cached]
        self._store_split(digest, uid, results, scoped_global_indexes,
                          scoped_pids)
        stamp = {'seconds': ts}
        lists = []
        for pid in sorted(cached):
            row = cached[pid]
            if row['r']:
                lists.append([dict(r, timestamp=stamp) for r in row['r']])
        if results:
            lists.append(list(results))
        merged = list(heapq.merge(*lists, key=_sort_key)) if lists else []
        msum = dict(_EMPTY_SUMMARY)
        for r in results:
            s = r.get('result', '')
            if s in msum:
                msum[s] += 1
        gidx = set(scoped_global_indexes)
        for pid, row in cached.items():
            for k, v in row['s'].items():
                msum[k] = msum.get(k, 0) + v
            l2g = self._l2g[pid]
            gidx.update(l2g[loc] for loc in row['p'] if loc < len(l2g))
        return merged, msum, sorted(gidx)

    def invalidate_uid(self, uid: str) -> int:
        return sum(sub.invalidate_uid(uid)
                   for sub in self._parts.values())

    # -- persistence -------------------------------------------------------

    def flush(self) -> bool:
        wrote = False
        for sub in self._parts.values():
            wrote = sub.flush() or wrote
        return wrote

    def stats(self) -> Dict[str, int]:
        entries = len(self)
        snapshot = sum(s.stats()['snapshot_bytes']
                       for s in self._parts.values())
        with self._lock:
            return {'entries': entries, 'snapshot_bytes': snapshot,
                    'partitions': len(self._parts),
                    'hits': self._hits, 'misses': self._misses,
                    'partial_hits': self._partials}
