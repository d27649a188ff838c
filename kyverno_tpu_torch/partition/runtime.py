"""Per-partition compile + evaluator lifecycle.

``build_runtime`` compiles each partition's member policies into its
own :class:`CompiledPolicySet` and evaluator.  The evaluator's compile
and AOT keys derive from the *partition* fingerprint
(``partition/keys.py``), so:

* editing a policy recompiles only its own partition — every other
  partition's evaluator (its K1v programs, one per pack layout) is
  reused verbatim from the in-process cache below;
* the executable ledger tags each record with the partition
  fingerprint, which is what lets ``partition/census.py`` attribute
  executables to partitions.

Each evaluator lives on one device (``build_evaluator(sub_cps,
device)``), so the cache is keyed by (partition fingerprint, device):
an evaluator built for the host is never handed to a scanner on the
card.

Every structural assumption (per-rule compile independence: the
partition's program list must be value-identical to the whole-set list
restricted to its members) is validated here; a mismatch raises
:class:`PartitionError` and the caller falls back to the monolithic
path.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .plan import (PartitionError, PartitionPlan, Partition, build_plan)

PARTITION_COUNT = 'kyverno_tpu_partition_count'
PARTITION_RECOMPILES = 'kyverno_tpu_partition_recompiles_total'
PARTITION_REUSES = 'kyverno_tpu_partition_evaluator_reuses_total'
PARTITION_FALLBACKS = 'kyverno_tpu_partition_fallbacks_total'


def _reg():
    from ..observability.metrics import global_registry
    return global_registry()


def _eval_cache_max() -> int:
    try:
        return max(0, int(os.environ.get(
            'KTPU_PARTITION_EVAL_CACHE', '128') or 0))
    except ValueError:
        return 128


# in-process evaluator cache keyed by (partition fingerprint, device):
# untouched partitions across scanner rebuilds (policy churn, handler
# hot-swap) reuse the same evaluator object — its K1v programs and
# ledger records all carry over
_cache_lock = threading.Lock()
_EVAL_CACHE: 'OrderedDict[Tuple[str, str], Tuple[object, object]]' = \
    OrderedDict()


def clear_eval_cache() -> None:
    with _cache_lock:
        _EVAL_CACHE.clear()


def eval_cache_size() -> int:
    with _cache_lock:
        return len(_EVAL_CACHE)


@dataclass
class PartitionRuntime:
    """One live partition: its compiled subset, evaluator, and the
    local→global program-column map the composer scatters through."""
    part: Partition
    sub_cps: object
    evaluator: object
    prog_cols: np.ndarray
    reused: bool = False

    @property
    def adm(self):
        return getattr(self.evaluator, 'adm_table', None)


@dataclass
class PartitionedSet:
    """The full partitioned compile of one policy set."""
    plan: PartitionPlan
    runtimes: Tuple[PartitionRuntime, ...]
    set_fingerprint: str = ''

    def recompiled(self) -> List[int]:
        return [rt.part.pid for rt in self.runtimes if not rt.reused]


def _programs_by_policy(cps) -> Dict[int, List[int]]:
    by_pol: Dict[int, List[int]] = {}
    for j, prog in enumerate(cps.programs):
        by_pol.setdefault(prog.policy_index, []).append(j)
    return by_pol


def _map_prog_cols(part: Partition, sub_cps, whole_cps) -> np.ndarray:
    """local program index -> whole-set program column, validated
    pairwise on (rule_name, rule_index) — per-rule compile independence
    made checkable."""
    local_by_pol = _programs_by_policy(sub_cps)
    whole_by_pol = _programs_by_policy(whole_cps)
    cols = np.empty(len(sub_cps.programs), np.int64)
    for m, g in enumerate(part.policy_indices):
        ljs = local_by_pol.get(m, [])
        gjs = whole_by_pol.get(g, [])
        if len(ljs) != len(gjs):
            raise PartitionError(
                f'partition {part.pid}: policy {g} lowered to '
                f'{len(ljs)} programs alone vs {len(gjs)} in the set')
        for lj, gj in zip(ljs, gjs):
            lp, gp = sub_cps.programs[lj], whole_cps.programs[gj]
            if (lp.rule_name, lp.rule_index) != \
                    (gp.rule_name, gp.rule_index):
                raise PartitionError(
                    f'partition {part.pid}: program order diverged for '
                    f'policy {g} rule {gp.rule_name!r}')
            cols[lj] = gj
    return cols


def _acquire(part: Partition, members: Sequence,
             device) -> Tuple[object, object, bool]:
    """(sub_cps, evaluator, reused) for one partition on ``device``, via
    the (fingerprint, device)-keyed evaluator cache."""
    key = (part.fingerprint, str(device))
    with _cache_lock:
        hit = _EVAL_CACHE.get(key)
        if hit is not None:
            _EVAL_CACHE.move_to_end(key)
            return hit[0], hit[1], True
    from ..compiler.compile import compile_policies
    from ..ops.eval import build_evaluator
    sub_cps = compile_policies(list(members))
    evaluator = build_evaluator(sub_cps, device)
    with _cache_lock:
        _EVAL_CACHE[key] = (sub_cps, evaluator)
        limit = _eval_cache_max()
        while limit and len(_EVAL_CACHE) > limit:
            _EVAL_CACHE.popitem(last=False)
    return sub_cps, evaluator, False


def build_runtime(policies: Sequence, whole_cps, n_parts: int,
                  set_fingerprint: str = '',
                  device=None) -> PartitionedSet:
    """Partition ``policies`` and compile (or reuse) each partition's
    evaluator on ``device`` (default: the CUDA card; raises without
    one — pass ``device='cpu'`` for the host).  ``whole_cps`` is the
    monolithic compile the scanner already built — the source of truth
    the per-partition program maps are validated against."""
    from ..device import resolve_device
    device = resolve_device(device)
    plan = build_plan(policies, n_parts)
    runtimes = []
    reused = 0
    for part in plan.partitions:
        members = [policies[i] for i in part.policy_indices]
        sub_cps, evaluator, hit = _acquire(part, members, device)
        if not sub_cps.programs:
            # host-only partition: no device programs to own; the
            # whole-set host matcher handles its policies
            continue
        cols = _map_prog_cols(part, sub_cps, whole_cps)
        runtimes.append(PartitionRuntime(
            part=part, sub_cps=sub_cps, evaluator=evaluator,
            prog_cols=cols, reused=hit))
        reused += 1 if hit else 0
    reg = _reg()
    if reg is not None:
        fresh = len(runtimes) - reused
        if fresh:
            reg.inc(PARTITION_RECOMPILES, float(fresh))
        if reused:
            reg.inc(PARTITION_REUSES, float(reused))
        # live partition-runtime occupancy: must read 0 once drained
        reg.mark_reset_on_close(PARTITION_COUNT)
        reg.set_gauge(PARTITION_COUNT, float(len(runtimes)))
    return PartitionedSet(plan=plan, runtimes=tuple(runtimes),
                          set_fingerprint=set_fingerprint)
