"""Partition census: which partitions are live, which executables they
own, and the hot-swap history — the data behind ``/debug/partitions``.

The executable ledger (``observability/executables.py``) records every
executable with the fingerprint of the evaluator that built it.  In
partitioned mode that is the *partition* fingerprint, so joining the
ledger against the registered plans attributes each executable — and
its dispatch/device-time/build-time totals — to the partition that owns
it.  Records that match no registered partition (monolithic evaluators,
stale generations) are reported under ``unattributed``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

_lock = threading.Lock()
#: set fingerprint -> {'plan': PartitionPlan, 'serial': int, 'ts': float}
_plans: Dict[str, dict] = {}
_swaps: Deque[dict] = deque(maxlen=64)


def record_plan(set_fingerprint: str, plan, serial: Optional[int] = None,
                diff=None) -> None:
    """Register the partition plan a scanner was built from."""
    with _lock:
        _plans[set_fingerprint] = {
            'plan': plan,
            'serial': serial,
            'ts': time.time(),
            'diff': diff.to_dict() if diff is not None else None,
        }
        while len(_plans) > 16:
            oldest = min(_plans, key=lambda k: _plans[k]['ts'])
            del _plans[oldest]


def record_swap(kind: str, old_serial, new_serial,
                breaker_state: Optional[str] = None,
                touched=None) -> None:
    """Log one live scanner hot-swap (for ``/debug/partitions``)."""
    with _lock:
        _swaps.append({
            'ts': time.time(),
            'kind': kind,
            'old_serial': old_serial,
            'new_serial': new_serial,
            'breaker_state': breaker_state,
            'touched_partitions': list(touched) if touched else None,
        })


def reset() -> None:
    with _lock:
        _plans.clear()
        _swaps.clear()


def report() -> dict:
    """Join registered plans against the executable ledger."""
    from ..observability import executables as exe
    with _lock:
        plans = dict(_plans)
        swaps = list(_swaps)

    by_fp: Dict[str, dict] = {}
    records = exe.ledger().records() if exe.enabled() else []
    for rec in records:
        row = by_fp.setdefault(rec.fingerprint, {
            'executables': 0, 'dispatches': 0,
            'device_s': 0.0, 'build_s': 0.0, 'by_source': {}})
        row['executables'] += 1
        row['dispatches'] += rec.dispatches
        row['device_s'] += rec.device_s
        row['build_s'] += rec.build_s
        row['by_source'][rec.source] = \
            row['by_source'].get(rec.source, 0) + 1

    sets = []
    claimed = set()
    for set_fp, info in sorted(plans.items(),
                               key=lambda kv: kv[1]['ts'], reverse=True):
        plan = info['plan']
        parts = []
        for part in plan.partitions:
            exe_row = by_fp.get(part.fingerprint)
            if exe_row is not None:
                claimed.add(part.fingerprint)
            parts.append({**part.to_dict(),
                          'executables': exe_row or {
                              'executables': 0, 'dispatches': 0,
                              'device_s': 0.0, 'build_s': 0.0,
                              'by_source': {}}})
        sets.append({'set_fingerprint': set_fp,
                     'serial': info['serial'],
                     'n_parts': plan.n_parts,
                     'n_partitions': len(plan.partitions),
                     'last_diff': info['diff'],
                     'partitions': parts})

    unattributed = {fp: row for fp, row in by_fp.items()
                    if fp not in claimed}
    return {'sets': sets,
            'swaps': swaps,
            'unattributed': {
                'fingerprints': len(unattributed),
                'executables': sum(r['executables']
                                   for r in unattributed.values()),
                'dispatches': sum(r['dispatches']
                                  for r in unattributed.values())}}
