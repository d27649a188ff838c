"""Decision provenance: per-decision attribution + the flight recorder.

PR 5 (micro-batching) and PR 6 (verdict cache) made individual
decisions invisible: one ``kyverno/serving/batch`` span serves up to 64
riders, cache replays never touch the device, and sheds land on the
host loop.  This module restores the per-request view — every admission
decision and every background-rescan row yields exactly one
:class:`DecisionRecord` naming the **serving path** that answered it:

* ``batch`` — rode a shared device dispatch (admission micro-batch or
  the rescan tick's dense scan); carries the batch id, its occupancy,
  and the **amortized device-time share** (batch ``device_eval`` stage
  time ÷ riders — shares of one batch sum to the batch's device time);
* ``sync`` — its own per-request device scan;
* ``shed:<reason>`` — left the batched fast path (reason from
  ``serving/shed.py``) and was served by the host engine loop;
* ``cache_replay`` — replayed from the digest-keyed verdict cache
  (carries the verdict digest, zero device share);
* ``host_fallback`` — the host engine loop served it directly (scanner
  still compiling, non-CREATE operation, exceptions present, device
  disabled, or a sync scan failure).

Records are exported three ways: (1) as attributes on the decision's
existing span, so the JSONL trace exporter carries them for free;
(2) through the bounded in-memory **flight recorder** ring (last
``KTPU_FLIGHT_N`` records, error/shed records kept in a second ring)
served at ``GET /debug/decisions`` and dumped to a JSONL file when the
d2h stall watchdog or a scan error fires; (3) on the cataloged
``kyverno_tpu_decision_duration_seconds{path}`` and
``kyverno_tpu_decision_device_share_seconds`` series.

Provenance never changes verdicts: records ride telemetry, not
``PolicyReport`` — everything here is a no-op until :func:`configure`
runs (and ``KTPU_FLIGHT_N=0`` keeps it off even then), with report and
admission output pinned bit-identical either way by
``tests/test_provenance.py``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import tracing
from .metrics import MetricsRegistry, global_registry

DECISION_DURATION = 'kyverno_tpu_decision_duration_seconds'
DECISION_DEVICE_SHARE = 'kyverno_tpu_decision_device_share_seconds'

#: decision latencies span sub-ms cache replays to multi-second
#: host-loop sweeps of 1k-policy sets
DURATION_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
#: amortized device shares live at (device_eval ÷ occupancy) — tens of
#: microseconds for a full batch up to ~1s for an unbatched cold scan
SHARE_BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)

_DEFAULT_FLIGHT_N = 512

_batch_seq = itertools.count(1)


def _env_flight_n() -> int:
    try:
        return int(os.environ.get('KTPU_FLIGHT_N',
                                  str(_DEFAULT_FLIGHT_N)))
    except ValueError:
        return _DEFAULT_FLIGHT_N


def _env_dump_dir() -> Optional[str]:
    root = os.environ.get(
        'KTPU_FLIGHT_DUMP_DIR',
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), '.cache', 'flight'))
    return root or None


def next_batch_id(prefix: str = 'b') -> str:
    """Process-unique id for one shared dispatch (admission batch or
    rescan tick); riders of the same dispatch share it."""
    return f'{prefix}{next(_batch_seq)}'


def _engine_rev() -> str:
    from ..verdictcache.keys import engine_rev
    return engine_rev()  # memoized at the source


class DecisionRecord:
    """One decision's provenance.  Plain data: built once at decision
    completion, then only read (ring, endpoint, dump, span attrs)."""

    __slots__ = ('ts', 'trace_id', 'span_id', 'path', 'source', 'uid',
                 'kind', 'namespace', 'name', 'operation', 'duration_s',
                 'queue_wait_s', 'batch_id', 'occupancy',
                 'device_share_s', 'device_eval_s', 'aot_cache',
                 'coverage_ratio', 'fingerprint', 'engine_rev',
                 'verdict_digest', 'error')

    def __init__(self, ts: float, path: str, source: str, uid: str,
                 kind: str, namespace: str, name: str, operation: str,
                 duration_s: float, queue_wait_s: float, batch_id: str,
                 occupancy: int, device_share_s: float,
                 device_eval_s: float, aot_cache: str,
                 coverage_ratio: Optional[float], fingerprint: str,
                 engine_rev: str, verdict_digest: str, error: str,
                 trace_id: str = '', span_id: str = ''):
        self.ts = ts
        self.trace_id = trace_id
        self.span_id = span_id
        self.path = path
        self.source = source
        self.uid = uid
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.operation = operation
        self.duration_s = duration_s
        self.queue_wait_s = queue_wait_s
        self.batch_id = batch_id
        self.occupancy = occupancy
        self.device_share_s = device_share_s
        self.device_eval_s = device_eval_s
        self.aot_cache = aot_cache
        self.coverage_ratio = coverage_ratio
        self.fingerprint = fingerprint
        self.engine_rev = engine_rev
        self.verdict_digest = verdict_digest
        self.error = error

    @property
    def is_error(self) -> bool:
        return bool(self.error) or self.path.startswith('shed:')

    def to_dict(self) -> dict:
        out = {}
        for k in self.__slots__:
            v = getattr(self, k)
            if v in ('', None, 0, 0.0) and k not in ('ts', 'path',
                                                     'source'):
                continue  # compact: omit empty fields
            out[k] = round(v, 9) if isinstance(v, float) and k != 'ts' \
                else v
        return out


class FlightRecorder:
    """Bounded ring of the last N decision records, with error/shed
    records kept separately so a burst of healthy traffic cannot evict
    the interesting ones.  ``dump`` persists both rings as JSONL —
    fired automatically when the d2h stall watchdog or a scan error
    trips (rate-limited per trigger so a stall storm cannot fill the
    disk)."""

    DUMP_MIN_INTERVAL_S = 10.0

    def __init__(self, maxlen: int, dump_dir: Optional[str] = None,
                 now: Callable[[], float] = time.time):
        self.maxlen = maxlen
        self.dump_dir = dump_dir
        self.now = now
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=maxlen)
        self._errors: deque = deque(maxlen=maxlen)
        self._counts: Dict[str, int] = {}
        self._total = 0
        self._dump_seq = itertools.count(1)
        self._last_dump: Dict[str, float] = {}
        self.dump_paths: List[str] = []

    # -- writes ------------------------------------------------------------

    def record(self, rec: DecisionRecord) -> None:
        with self._lock:
            self._records.append(rec)
            if rec.is_error:
                self._errors.append(rec)
            self._counts[rec.path] = self._counts.get(rec.path, 0) + 1
            self._total += 1

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._errors.clear()
            self._counts.clear()
            self._total = 0

    # -- reads -------------------------------------------------------------

    def records(self, limit: Optional[int] = None) -> List[DecisionRecord]:
        with self._lock:
            out = list(self._records)
        return out[-limit:] if limit else out

    def errors(self, limit: Optional[int] = None) -> List[DecisionRecord]:
        with self._lock:
            out = list(self._errors)
        return out[-limit:] if limit else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {'total': self._total, 'by_path': dict(self._counts),
                    'ring': len(self._records),
                    'error_ring': len(self._errors),
                    'capacity': self.maxlen}

    # -- dumps -------------------------------------------------------------

    def dump(self, trigger: str, force: bool = False) -> Optional[str]:
        """Write both rings to ``<dump_dir>/decisions-<trigger>-<n>.jsonl``
        (header line first).  Returns the path, or None when the dump
        directory is unset/unwritable or the trigger is rate-limited."""
        if self.dump_dir is None:
            return None
        now = self.now()
        with self._lock:
            last = self._last_dump.get(trigger, 0.0)
            if not force and now - last < self.DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[trigger] = now
            records = list(self._records)
            errors = list(self._errors)
        path = os.path.join(
            self.dump_dir,
            f'decisions-{trigger}-{os.getpid()}-{next(self._dump_seq)}'
            f'.jsonl')
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, 'w') as f:
                f.write(json.dumps({
                    'trigger': trigger, 'ts': now,
                    'records': len(records), 'errors': len(errors)})
                    + '\n')
                for rec in records:
                    f.write(json.dumps(
                        dict(rec.to_dict(), ring='decisions')) + '\n')
                for rec in errors:
                    f.write(json.dumps(
                        dict(rec.to_dict(), ring='errors')) + '\n')
        except OSError:
            return None
        self.dump_paths.append(path)
        return path


# -- module state -----------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_registry: Optional[MetricsRegistry] = None
_stall_sink: Optional[Callable[[dict], None]] = None


def configure(registry: Optional[MetricsRegistry] = None,
              flight_n: Optional[int] = None,
              dump_dir: Optional[str] = None,
              now: Callable[[], float] = time.time
              ) -> Optional[FlightRecorder]:
    """Enable decision provenance.  ``flight_n`` defaults to
    ``KTPU_FLIGHT_N`` (0 disables entirely — the off state the
    bit-identity tests pin against); ``dump_dir`` defaults to
    ``KTPU_FLIGHT_DUMP_DIR``.  Idempotent; :func:`disable` undoes it."""
    global _recorder, _registry, _stall_sink
    n = _env_flight_n() if flight_n is None else flight_n
    if n <= 0:
        disable()
        return None
    reg = registry or global_registry()
    if reg is not None:
        # bucket overrides must land before the first observe
        reg.register_histogram(DECISION_DURATION, DURATION_BUCKETS)
        reg.register_histogram(DECISION_DEVICE_SHARE, SHARE_BUCKETS)
    recorder = FlightRecorder(
        n, dump_dir if dump_dir is not None else _env_dump_dir(),
        now=now)
    if _stall_sink is None:
        # the d2h stall watchdog's structured event triggers a flight
        # dump: the ring's recent history lands on disk next to the
        # stall it explains
        def sink(event: dict) -> None:
            r = _recorder
            if r is not None:
                r.dump('d2h_stall')
        from . import device
        device.add_event_sink(sink)
        _stall_sink = sink
    _registry = reg
    _recorder = recorder
    return recorder


def disable() -> None:
    global _recorder, _registry, _stall_sink
    _recorder = None
    _registry = None
    if _stall_sink is not None:
        from . import device
        device.remove_event_sink(_stall_sink)
        _stall_sink = None


def recorder() -> Optional[FlightRecorder]:
    return _recorder


def enabled() -> bool:
    """The zero-overhead gate decision sites check (one global read)."""
    return _recorder is not None


def notify_scan_error(error: BaseException) -> None:
    """A device scan raised (sync or batched dispatch): dump the flight
    rings so the decisions leading up to the failure are on disk."""
    r = _recorder
    if r is not None:
        r.dump('scan_error')


def record_decision(path: str, source: str = 'admission', uid: str = '',
                    kind: str = '', namespace: str = '', name: str = '',
                    operation: str = '', duration_s: float = 0.0,
                    queue_wait_s: float = 0.0, batch_id: str = '',
                    occupancy: int = 0, device_share_s: float = 0.0,
                    device_eval_s: float = 0.0, aot_cache: str = '',
                    coverage_ratio: Optional[float] = None,
                    fingerprint: str = '', verdict_digest: str = '',
                    error: str = '') -> Optional[DecisionRecord]:
    """Build + publish one decision's record (no-op when provenance is
    unconfigured).  Stamps the ambient span (trace/span id into the
    record, the record's provenance fields onto the span so the JSONL
    exporter carries them) and the per-path decision metrics."""
    rec_sink = _recorder
    if rec_sink is None:
        return None
    span = tracing.current_span()
    trace_id = getattr(span, 'trace_id', '') if span is not None else ''
    span_id = getattr(span, 'span_id', '') if span is not None else ''
    rec = DecisionRecord(
        ts=rec_sink.now(), path=path, source=source, uid=uid, kind=kind,
        namespace=namespace, name=name, operation=operation,
        duration_s=duration_s, queue_wait_s=queue_wait_s,
        batch_id=batch_id, occupancy=occupancy,
        device_share_s=device_share_s, device_eval_s=device_eval_s,
        aot_cache=aot_cache, coverage_ratio=coverage_ratio,
        fingerprint=fingerprint, engine_rev=_engine_rev(),
        verdict_digest=verdict_digest, error=error,
        trace_id=trace_id, span_id=span_id)
    rec_sink.record(rec)
    if span is not None:
        span.set_attribute('decision_path', path)
        if batch_id:
            span.set_attribute('decision_batch_id', batch_id)
            span.set_attribute('decision_occupancy', occupancy)
        if device_share_s:
            span.set_attribute('decision_device_share_s',
                               round(device_share_s, 9))
        if verdict_digest:
            span.set_attribute('decision_verdict_digest', verdict_digest)
    reg = _registry or global_registry()
    if reg is not None:
        reg.observe(DECISION_DURATION, duration_s, path=path)
        if path in ('batch', 'sync'):
            reg.observe(DECISION_DEVICE_SHARE, device_share_s)
    return rec


# -- bench / endpoint views --------------------------------------------------

def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


def breakdown() -> Dict[str, Any]:
    """The ``decision_breakdown`` block ``bench.py`` embeds: per-path
    decision counts + p50/p95 latency, and the device-share histogram
    over batch/sync decisions — the homogeneous-vs-heterogeneous
    occupancy gap as a tracked number."""
    r = _recorder
    if r is None:
        return {}
    records = r.records()
    by_path: Dict[str, List[float]] = {}
    shares: List[float] = []
    for rec in records:
        by_path.setdefault(rec.path, []).append(rec.duration_s)
        if rec.path in ('batch', 'sync'):
            shares.append(rec.device_share_s)
    paths = {}
    stats = r.stats()
    for path, vals in sorted(by_path.items()):
        vals.sort()
        paths[path] = {
            'count': stats['by_path'].get(path, len(vals)),
            'p50_ms': round(_pctl(vals, 0.50) * 1000.0, 3),
            'p95_ms': round(_pctl(vals, 0.95) * 1000.0, 3),
        }
    share_hist: Dict[str, int] = {}
    for s in shares:
        for bound in SHARE_BUCKETS:
            if s <= bound:
                key = f'le_{bound}'
                share_hist[key] = share_hist.get(key, 0) + 1
                break
        else:
            share_hist['le_inf'] = share_hist.get('le_inf', 0) + 1
    shares.sort()
    return {
        'decisions': stats['total'],
        'paths': paths,
        'device_share': {
            'count': len(shares),
            'mean_s': round(sum(shares) / len(shares), 9)
            if shares else 0.0,
            'p50_s': round(_pctl(shares, 0.50), 9),
            'p95_s': round(_pctl(shares, 0.95), 9),
            'hist': share_hist,
        },
    }
