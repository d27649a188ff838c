"""Stable policy-set partitioning + the churn differ.

A **partition plan** splits a policy set into at most ``KTPU_PARTITIONS``
buckets.  The grouping key is the policy's *coupling signature* — the
resource-kind vocabulary its match/exclude blocks reference plus the
validation lowering families its rules use — sharded by the policy's
identity (``namespace/name``) through sha256.  Two properties follow:

* **Stability** — a policy keeps its bucket as long as its vocabulary
  and identity are unchanged; editing one rule's pattern or message
  touches exactly one partition's fingerprint.  sha256 (not Python
  ``hash()``, which is salted per process) keeps the assignment
  identical across processes, so a second process derives the same
  partition fingerprints and warm-loads untouched partitions from the
  AOT store.
* **Affinity** — policies sharing a vocabulary signature hash from a
  common prefix, so coupled policies (same kinds, same lowering shape)
  tend to co-locate, keeping per-partition encode vocabularies small.

Correctness never depends on the grouping: the composition layer
(``partition/compose.py``) merges per-partition verdict buffers into
the whole-set contract bit-identically for *any* assignment.

The **differ** maps a policy add/update/delete to the partitions it
touches: partitions present in both plans with equal fingerprints are
untouched (their executables, ledger records and verdict generations
carry over); everything else recompiles.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: validation keys that select a lowering family — part of the coupling
#: signature (policies lowered the same way share compiled structure)
_VALIDATE_FAMILIES = ('pattern', 'anyPattern', 'deny', 'foreach',
                      'podSecurity', 'cel')


class PartitionError(Exception):
    """The partition plan or runtime could not be validated against the
    whole-set compile; callers fall back to the monolithic path."""


def env_partitions() -> int:
    """``KTPU_PARTITIONS``: number of partition buckets (0 = off, the
    monolithic oracle)."""
    try:
        return max(0, int(os.environ.get('KTPU_PARTITIONS', '0') or 0))
    except ValueError:
        return 0


def _iter_clause_kinds(block: dict):
    for clause in [block] + list(block.get('any') or []) + \
            list(block.get('all') or []):
        res = (clause or {}).get('resources') or {}
        for k in res.get('kinds') or []:
            yield str(k)


def coupling_signature(policy) -> str:
    """The vocabulary half of the bucket key: sorted match/exclude
    resource kinds + the validation lowering families the rules use.
    A JSON string so it is hashable, diffable and process-stable."""
    spec = (getattr(policy, 'raw', None) or {}).get('spec') or {}
    kinds = set()
    families = set()
    for rule in spec.get('rules') or []:
        if not isinstance(rule, dict):
            continue
        for part in ('match', 'exclude'):
            kinds.update(_iter_clause_kinds(rule.get(part) or {}))
        validate = rule.get('validate') or {}
        families.update(f for f in _VALIDATE_FAMILIES if f in validate)
    return json.dumps([sorted(kinds), sorted(families)],
                      separators=(',', ':'))


def _bucket(policy, n_parts: int) -> int:
    ident = f'{policy.namespace}/{policy.name}'
    key = coupling_signature(policy) + '\x00' + ident
    return int(hashlib.sha256(key.encode()).hexdigest()[:12], 16) % n_parts


@dataclass(frozen=True)
class Partition:
    """One bucket of the plan: member policies (global indices in set
    order) and the fingerprint their compile keys derive from."""
    pid: int
    policy_indices: Tuple[int, ...]
    fingerprint: str

    def to_dict(self) -> dict:
        return {'pid': self.pid,
                'fingerprint': self.fingerprint,
                'n_policies': len(self.policy_indices)}


@dataclass(frozen=True)
class PartitionPlan:
    """The full assignment: ``partitions`` holds the non-empty buckets
    in pid order; ``assignment[i]`` is policy *i*'s pid."""
    n_parts: int
    partitions: Tuple[Partition, ...]
    assignment: Tuple[int, ...]

    def by_pid(self) -> Dict[int, Partition]:
        return {p.pid: p for p in self.partitions}

    def members(self, policies: Sequence, pid: int) -> List:
        part = self.by_pid().get(pid)
        if part is None:
            return []
        return [policies[i] for i in part.policy_indices]


def build_plan(policies: Sequence, n_parts: int) -> PartitionPlan:
    """Deterministic plan over ``policies``.  Membership order within a
    bucket follows global set order, so an untouched bucket's member
    list — and therefore its fingerprint and every local index stored
    against it — is reproducible across processes and across churn."""
    from .keys import partition_fingerprint
    if n_parts <= 0:
        raise PartitionError('n_parts must be positive')
    assignment = [_bucket(p, n_parts) for p in policies]
    buckets: Dict[int, List[int]] = {}
    for i, pid in enumerate(assignment):
        buckets.setdefault(pid, []).append(i)
    partitions = tuple(
        Partition(pid=pid, policy_indices=tuple(idxs),
                  fingerprint=partition_fingerprint(
                      [policies[i] for i in idxs]))
        for pid, idxs in sorted(buckets.items()))
    return PartitionPlan(n_parts=n_parts, partitions=partitions,
                         assignment=tuple(assignment))


@dataclass(frozen=True)
class ChurnDiff:
    """Which partitions a policy-set change touches.  ``touched`` pids
    must recompile (fingerprint changed, bucket appeared, or bucket
    emptied); ``unchanged`` pids keep their executables, ledger records
    and verdict-cache generations."""
    touched: Tuple[int, ...]
    unchanged: Tuple[int, ...]

    def to_dict(self) -> dict:
        return {'touched': list(self.touched),
                'unchanged': list(self.unchanged)}


def diff_plans(old: Optional[PartitionPlan],
               new: PartitionPlan) -> ChurnDiff:
    """Map a policy-set change to touched partitions by fingerprint.
    ``old=None`` (first build) touches everything."""
    new_by = new.by_pid()
    if old is None:
        return ChurnDiff(touched=tuple(sorted(new_by)), unchanged=())
    old_by = old.by_pid()
    touched = []
    unchanged = []
    for pid in sorted(set(old_by) | set(new_by)):
        a, b = old_by.get(pid), new_by.get(pid)
        if a is not None and b is not None and \
                a.fingerprint == b.fingerprint:
            unchanged.append(pid)
        else:
            touched.append(pid)
    return ChurnDiff(touched=tuple(touched), unchanged=tuple(unchanged))
