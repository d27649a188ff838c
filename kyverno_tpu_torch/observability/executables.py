"""Executable ledger: a lifecycle record for every compiled program.

The port's compiled program is a K1v program: ``ops/vm.py`` lowers an
evaluator's status trees and admission entries to bytecode once per pack
layout (``evaluator.plan_for(layout)`` in ``ops/eval.py``), and
``csrc/k1_vm.cu`` interprets it.  This module registers an
:class:`ExecutableRecord` each time ``plan_for`` lowers a program for a
new layout (source ``fresh_compile``), and accounts every K1 call that
dispatches it.

Each record carries the fingerprint of the evaluator's policies (the
whole set, or one partition's members under ``KTPU_PARTITIONS``), the
lowering's duration, the program's costs (:func:`cost_analysis`),
cumulative dispatch count + host dispatch seconds, and the last-used
timestamp.  A program serves every row count of its layout, so the
record's capacity is 0.  Evictions mark the record instead of silently
removing it.

Exports: ``kyverno_tpu_executable_count{source}`` (live records),
``kyverno_tpu_executable_dispatches_total{source}`` and
``kyverno_tpu_executable_device_seconds_total{source}``; the full table
serves at ``GET /debug/executables`` (JSON, ``?format=table`` for a
terminal view); build/evict lifecycle events ride the existing tracer
exporters as zero-duration ``kyverno/executable/<event>`` spans, so a
``tracing.configure(jsonl_path=...)`` run leaves a JSONL lifecycle log
for free.

Same no-op contract as the rest of telemetry: nothing is recorded until
:func:`configure` runs (``KTPU_EXEC_LEDGER_N=0`` keeps it off), and the
ledger rides telemetry, never the scan output.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from . import tracing
from .metrics import MetricsRegistry, global_registry

EXEC_COUNT = 'kyverno_tpu_executable_count'
EXEC_DISPATCHES = 'kyverno_tpu_executable_dispatches_total'
EXEC_DEVICE_SECONDS = 'kyverno_tpu_executable_device_seconds_total'

#: executable acquisition sources, in "how much did it cost" order
SOURCES = ('fresh_compile', 'aot_load')

_DEFAULT_LEDGER_N = 256


def _env_ledger_n() -> int:
    try:
        return int(os.environ.get('KTPU_EXEC_LEDGER_N',
                                  str(_DEFAULT_LEDGER_N)))
    except ValueError:
        return _DEFAULT_LEDGER_N


def cost_analysis(program) -> Dict[str, float]:
    """A K1v program's costs (``ops/vm.py Program``): the instructions
    one row executes with every loop at full width and the packed-lane
    bytes its bytecode reads per row (what chip_smoke's bound uses), the
    output bytes per row, its entries, parts and groups, and the groups
    staged in shared memory with a block's dynamic shared memory.  {}
    without a program (an evaluator whose trees all take the eager
    walk)."""
    if program is None:
        return {}
    return {
        'row_insns': float(program.row_insns),
        'row_bytes': float(program.row_bytes),
        'out_row_bytes': float(2 * program.n_uniq + 4 * program.n_cols_u
                               + program.n_adm),
        'entries': float(program.n_entries),
        'parts': float(sum(program.tree_parts.values())),
        'groups': float(program.n_groups),
        'staged_groups': float(program.n_staged),
        'smem_bytes': float(program.smem_bytes),
    }


class ExecutableRecord:
    """One compiled program's lifecycle.  Mutated only under the
    ledger's lock (dispatch accounting, eviction marking)."""

    __slots__ = ('key', 'fingerprint', 'capacity', 'source', 'build_s',
                 'costs', 'dispatches', 'device_s',
                 'created_ts', 'last_used_ts', 'evicted', 'evict_reason')

    def __init__(self, key: str, fingerprint: str, capacity: int,
                 source: str, build_s: float, costs: Dict[str, float],
                 ts: float):
        self.key = key
        self.fingerprint = fingerprint
        self.capacity = capacity
        self.source = source
        self.build_s = build_s
        self.costs = costs
        self.dispatches = 0
        self.device_s = 0.0
        self.created_ts = ts
        self.last_used_ts = ts
        self.evicted = False
        self.evict_reason = ''

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {
            'key': self.key[:16],
            'fingerprint': self.fingerprint[:16],
            'capacity': self.capacity,
            'source': self.source,
            'build_s': round(self.build_s, 6),
            'dispatches': self.dispatches,
            'device_s': round(self.device_s, 6),
            'created_ts': self.created_ts,
            'last_used_ts': self.last_used_ts,
        }
        out.update(self.costs)
        if self.evicted:
            out['evicted'] = True
            out['evict_reason'] = self.evict_reason
        return out


class ExecutableLedger:
    """Bounded registry of executable records, keyed by a digest of
    (evaluator fingerprint, pack layout, fail-detail budget).  Over
    the bound, the least-recently-used record is dropped — a churn-heavy
    future (incremental recompiles) cannot grow it without bound."""

    def __init__(self, maxlen: int,
                 registry: Optional[MetricsRegistry] = None,
                 now: Callable[[], float] = time.time):
        self.maxlen = maxlen
        self.registry = registry
        self.now = now
        self._lock = threading.Lock()
        self._records: 'OrderedDict[str, ExecutableRecord]' = OrderedDict()

    # -- writes ------------------------------------------------------------

    def record_build(self, key: str, fingerprint: str = '',
                     capacity: int = 0, source: str = 'fresh_compile',
                     build_s: float = 0.0,
                     compiled: Any = None) -> ExecutableRecord:
        costs = cost_analysis(compiled) if compiled is not None else {}
        with self._lock:
            rec = self._records.pop(key, None)
            if rec is not None and not rec.evicted:
                # re-acquisition of a known key (e.g. recompile after an
                # eviction raced): refresh source + build cost, keep the
                # cumulative dispatch history
                rec.source = source
                rec.build_s = build_s
                rec.last_used_ts = self.now()
            else:
                rec = ExecutableRecord(
                    key=key, fingerprint=fingerprint, capacity=capacity,
                    source=source, build_s=build_s, costs=costs,
                    ts=self.now())
            self._records[key] = rec
            while len(self._records) > self.maxlen:
                self._records.popitem(last=False)
            self._set_count_gauges()
        self._lifecycle_event('build', rec)
        return rec

    def record_dispatch(self, key: str, device_s: float) -> None:
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.dispatches += 1
            rec.device_s += device_s
            rec.last_used_ts = self.now()
            self._records.move_to_end(key)
            source = rec.source
        reg = self.registry or global_registry()
        if reg is not None:
            reg.inc(EXEC_DISPATCHES, source=source)
            reg.inc(EXEC_DEVICE_SECONDS, float(device_s), source=source)

    def record_eviction(self, key: str, reason: str) -> None:
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.evicted = True
            rec.evict_reason = reason
            self._set_count_gauges()
        self._lifecycle_event('evict', rec)

    # -- metric + lifecycle plumbing ---------------------------------------

    def _set_count_gauges(self) -> None:
        """Live (non-evicted) record count per source — called under
        the lock after every membership change so the gauge tracks the
        ledger exactly."""
        reg = self.registry or global_registry()
        if reg is None:
            return
        counts = {s: 0 for s in SOURCES}
        for rec in self._records.values():
            if not rec.evicted:
                counts[rec.source] = counts.get(rec.source, 0) + 1
        # the ledger's live record count is residency — a shut-down
        # process holds no executables, so the series must drain to 0
        reg.mark_reset_on_close(EXEC_COUNT)
        for source, n in counts.items():
            reg.set_gauge(EXEC_COUNT, float(n), source=source)

    def _lifecycle_event(self, event: str, rec: ExecutableRecord) -> None:
        """Build/evict event as a zero-duration span: the existing
        tracer exporters (memory ring, JSONL file) carry the executable
        lifecycle log with no new export machinery."""
        tr = tracing.tracer()
        if not tr.enabled:
            return
        attrs: Dict[str, Any] = {
            'key': rec.key[:16], 'fingerprint': rec.fingerprint[:16],
            'capacity': rec.capacity, 'source': rec.source,
            'build_s': round(rec.build_s, 6),
        }
        if event == 'evict':
            attrs['evict_reason'] = rec.evict_reason
            attrs['dispatches'] = rec.dispatches
            attrs['device_s'] = round(rec.device_s, 6)
        tr.start_span(f'kyverno/executable/{event}', attrs,
                      parent=tracing.current_span()).end()

    # -- reads -------------------------------------------------------------

    def records(self) -> List[ExecutableRecord]:
        with self._lock:
            return list(self._records.values())

    def census(self) -> Dict[str, Any]:
        """The compact summary (chip_smoke.py prints it): live counts
        by source + cumulative dispatch/device totals."""
        with self._lock:
            recs = list(self._records.values())
        by_source: Dict[str, int] = {}
        dispatches = 0
        device_s = 0.0
        build_s = 0.0
        for rec in recs:
            dispatches += rec.dispatches
            device_s += rec.device_s
            if not rec.evicted:
                by_source[rec.source] = by_source.get(rec.source, 0) + 1
                build_s += rec.build_s
        return {
            'live': sum(by_source.values()),
            'by_source': by_source,
            'dispatches': dispatches,
            'device_s': round(device_s, 6),
            'build_s': round(build_s, 6),
        }

    def report(self) -> Dict[str, Any]:
        """The ``/debug/executables`` JSON body."""
        return {
            'enabled': True,
            'capacity': self.maxlen,
            'census': self.census(),
            'executables': [rec.to_dict() for rec in self.records()],
        }

    def render_table(self) -> str:
        """Terminal view of the ledger (``?format=table``)."""
        header = (f'{"KEY":<18}{"FPRINT":<18}{"CAP":>6}  '
                  f'{"SOURCE":<14}{"BUILD_S":>10}{"DISP":>8}'
                  f'{"DEVICE_S":>11}  STATE')
        lines = [header, '-' * len(header)]
        for rec in self.records():
            state = f'evicted:{rec.evict_reason}' if rec.evicted \
                else 'live'
            lines.append(
                f'{rec.key[:16]:<18}{rec.fingerprint[:16]:<18}'
                f'{rec.capacity:>6}  {rec.source:<14}'
                f'{rec.build_s:>10.3f}{rec.dispatches:>8}'
                f'{rec.device_s:>11.4f}  {state}')
        if len(lines) == 2:
            lines.append('(no executables registered)')
        return '\n'.join(lines) + '\n'


# -- module state -----------------------------------------------------------

_ledger: Optional[ExecutableLedger] = None


def configure(registry: Optional[MetricsRegistry] = None,
              ledger_n: Optional[int] = None,
              now: Callable[[], float] = time.time
              ) -> Optional[ExecutableLedger]:
    """Enable the executable ledger.  ``ledger_n`` defaults to
    ``KTPU_EXEC_LEDGER_N`` (0 disables entirely — the off state the
    bit-identity tests pin against).  Idempotent; :func:`disable`
    undoes it."""
    global _ledger
    n = _env_ledger_n() if ledger_n is None else ledger_n
    if n <= 0:
        disable()
        return None
    _ledger = ExecutableLedger(n, registry or global_registry(), now=now)
    return _ledger


def disable() -> None:
    global _ledger
    _ledger = None


def ledger() -> Optional[ExecutableLedger]:
    return _ledger


def enabled() -> bool:
    """The zero-overhead gate the compile/dispatch sites check (one
    global read)."""
    return _ledger is not None


# -- registration hooks (called from ops/eval.py) ----------------------------

def record_build(key: str, fingerprint: str = '', capacity: int = 0,
                 source: str = 'fresh_compile', build_s: float = 0.0,
                 compiled: Any = None) -> None:
    led = _ledger
    if led is not None:
        led.record_build(key, fingerprint=fingerprint,
                         capacity=capacity, source=source,
                         build_s=build_s, compiled=compiled)


def record_dispatch(key: str, device_s: float) -> None:
    led = _ledger
    if led is not None:
        led.record_dispatch(key, device_s)


def record_eviction(key: str, reason: str) -> None:
    led = _ledger
    if led is not None:
        led.record_eviction(key, reason)


def census() -> Dict[str, Any]:
    """Bench view (empty when unconfigured)."""
    led = _ledger
    return led.census() if led is not None else {}
