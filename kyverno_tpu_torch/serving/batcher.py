"""The micro-batching loop: coalesce same-policy-set admission scans.

One daemon thread watches the bounded queue.  It picks the oldest
pending ticket, waits until that ticket's flush window expires
(``KTPU_BATCH_WINDOW_MS``, default ~2ms) or its key reaches
``KTPU_BATCH_MAX`` occupancy (default: the small canonical batch
capacity, ``compiler/shapes.py``), then dispatches all claimed tickets
of that key as ONE ``scanner.scan`` call and resolves their futures
row by row.

The coalescing key is the SCANNER ALONE (its monotonic serial): the
scanner threads each rider's admission tuple through the compiled
pipeline as per-row lanes (``compiler/admission.py``), so mixed-user,
mixed-role, mixed-verb bursts — the shape of real cluster traffic —
share one dispatch instead of degenerating to batch-of-one.  Scanners
without per-row admission support (``supports_row_admissions`` unset)
ride a residual key that appends the canonical admission tuple; every
such ticket is recorded on the coverage ledger
(``admission_unencodable``, path ``serving``) so the serialization is
never silent.

Batches are ragged: the scanner pads every dispatch to a canonical
capacity and the evaluator masks the tail rows in-graph, so a flush at
ANY occupancy reuses an already-compiled executable — there is no
bucket floor to align with, and ``KTPU_BATCH_MAX`` is purely a
latency/amortization trade (values above the small capacity make
batches pad to the next canonical capacity).

Dispatches are serialized on the batcher thread: ``BatchScanner.scan``
keeps per-scan state on the scanner instance, and one consumer at a
time is what makes the shared scanner safe by construction.  While a
dispatch runs, new arrivals accumulate in the queue — that accumulation
is where occupancy (and chip utilization) comes from.

Failure semantics: a dispatch that raises enters POISON QUARANTINE —
the batcher bisects the batch (bounded depth) and re-dispatches the
halves, so a single poison row no longer sheds N healthy riders: the
healthy riders resolve on device from their sub-dispatches, each
isolated poison row sheds to the host loop under reason ``poison_row``
(``stage_retry_exhausted`` when the failure was a pipeline stage that
exhausted its retry budget), and only a group still failing at the
depth bound sheds wholesale under ``scan_error``.  A singleton failure
gets one solo re-dispatch first, so transient device errors recover
with no shed at all.

The owning handler's per-policy-set circuit breaker hears at most ONE
verdict per original dispatch, and the verdict distinguishes
row-attributed evidence from infrastructure evidence: ``on_success``
when quarantine resolved any rider on device (the backend is healthy —
the failure was row-local); ``on_failure`` when nothing survived AND
the failure looks systemic — a wholesale shed (depth-bound group or a
retry-exhausted pipeline stage) or ``ALL_FAILED_BREAKER_AFTER``
consecutive all-failed dispatches of the same key.  A dispatch whose
only casualties were isolated poison rows (each failed twice solo —
row-attributed by construction) is breaker-NEUTRAL: an unlucky
all-poison batch must not quarantine the whole policy set to the host
loop, while a genuinely broken backend still trips the breaker via the
consecutive counter within a bounded number of dispatches.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from .. import faults
from ..observability import coverage, tracing
from ..observability.metrics import MetricsRegistry, global_registry
from . import shed as shed_policy
from .queue import RequestQueue, Ticket

QUEUE_DEPTH = 'kyverno_tpu_admission_queue_depth'
BATCH_OCCUPANCY = 'kyverno_tpu_admission_batch_occupancy'
HETERO_OCCUPANCY = 'kyverno_tpu_admission_hetero_occupancy'
QUEUE_WAIT = 'kyverno_tpu_admission_queue_wait_seconds'

#: occupancy counts requests per dispatch — power-of-two buckets up to
#: twice the default KTPU_BATCH_MAX
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
#: queue waits live at the flush window (~ms), far below the default
#: latency buckets' useful resolution
WAIT_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)

#: poison-quarantine bisection bound: KTPU_BATCH_MAX stays well under
#: 2**8, so singleton isolation always completes within the bound,
#: while a pathological failure storm stays O(depth * batch) dispatches
QUARANTINE_MAX_DEPTH = 8

#: consecutive all-failed dispatches of one key before poison-only
#: evidence escalates to a breaker failure anyway: poison sheds are
#: row-attributed (each row failed twice in isolation), so a single
#: all-poison batch is breaker-neutral — but a backend that fails
#: EVERY row of EVERY dispatch looks identical row-by-row, and this
#: bound is how long the batcher entertains the row-local theory
ALL_FAILED_BREAKER_AFTER = 3


def _canon(v):
    """Order-canonical view of one admission-tuple element: dict keys
    sort via json, and list/tuple values sort by their JSON form —
    roles/groups are membership sets for match semantics, so two
    requests differing only in list order must produce ONE key."""
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        items = [_canon(x) for x in v]
        try:
            return sorted(items, key=lambda x: json.dumps(
                x, sort_keys=True, default=str))
        except Exception:  # ktpu: noqa[KTPU304] -- key
            return items   # canonicalization, not a serving error:
            # mixed-type lists that refuse a total order keep their
            # arrival order (a worse coalescing key, never a failure)
    return v


def admission_key(admission: tuple) -> str:
    """Deterministic canonical string of the (admission_info,
    exclude_group_roles, namespace_labels, operation) tuple — JSON with
    sorted keys AND sorted scalar lists, positional at the top level.
    Used only by the residual fallback path (scanners without per-row
    admission lanes): such requests may only share a dispatch when this
    matches, and every use is recorded on the coverage ledger."""
    parts = [_canon(x) for x in admission] \
        if isinstance(admission, (list, tuple)) else _canon(admission)
    return json.dumps(parts, sort_keys=True, default=str,
                      separators=(',', ':'))


class AdmissionBatcher:
    """Queue + coalescing thread + shed accounting.

    ``on_success(policies)`` / ``on_failure(policies, error)`` hook the
    owning handler's circuit breaker, so a broken backend trips it from
    batched traffic exactly as it would from sync traffic.
    """

    def __init__(self,
                 window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 shed_deadline_ms: Optional[float] = None,
                 on_success: Optional[Callable] = None,
                 on_failure: Optional[Callable] = None):
        if window_ms is None:
            window_ms = float(os.environ.get('KTPU_BATCH_WINDOW_MS', '2'))
        if max_batch is None:
            raw_max = os.environ.get('KTPU_BATCH_MAX', '')
            if raw_max.strip():
                max_batch = int(raw_max)
            else:
                # default: fill the small canonical capacity exactly —
                # any occupancy is shape-safe (ragged batches), this is
                # just the point past which padding jumps capacities
                from ..compiler.shapes import small_capacity
                max_batch = small_capacity()
        if queue_cap is None:
            queue_cap = int(os.environ.get('KTPU_QUEUE_CAP', '256'))
        if shed_deadline_ms is None:
            shed_deadline_ms = float(os.environ.get(
                'KTPU_SHED_DEADLINE_MS', '500'))
        self.window_s = window_ms / 1000.0
        self.max_batch = max(1, max_batch)
        self.shed_deadline_s = shed_deadline_ms / 1000.0
        self.queue = RequestQueue(max(1, queue_cap))
        self.sheds = shed_policy.ShedLedger()
        self.on_success = on_success
        self.on_failure = on_failure
        self._stats_lock = threading.Lock()
        self._occupancies: deque = deque(maxlen=4096)
        self._hetero_occupancies: deque = deque(maxlen=4096)
        self._waits_s: deque = deque(maxlen=8192)
        self._dispatches = 0
        self._hetero_dispatches = 0
        self._requests = 0
        self._quarantine_dispatches = 0
        # consecutive all-failed dispatch count per key; touched only
        # by the batcher thread (dispatches are serialized), reset the
        # moment any rider of the key resolves on device
        self._all_failed: Dict = {}
        self._registered_on: Optional[MetricsRegistry] = None
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, name='ktpu-admission-batcher', daemon=True)
        self._thread.start()

    # -- submission (webhook threads) -------------------------------------

    def submit(self, resource: dict, context: Optional[dict], pctx,
               admission: tuple, scanner, policies,
               old_resource: Optional[dict] = None) -> Ticket:
        """Enqueue one request; raises QueueFull / Stopped (callers shed
        to the host loop).  The current span rides along so the batch
        span nests under the request's HTTP-handler span.  The key is
        the scanner's monotonic serial alone (validate and mutate
        compile distinct scanners, so program kinds never mix, while
        distinct users/roles/namespaces/verbs coalesce — the scanner
        consumes per-row admission tuples); scanners without per-row
        support fall back to serial + the canonical admission tuple,
        recorded on the coverage ledger.  UPDATE tickets carry their
        oldObject for the scanner's old-match retry."""
        serial = getattr(scanner, 'serial', None)
        sid = serial if serial is not None else id(scanner)
        if getattr(scanner, 'supports_row_admissions', False):
            key: tuple = ('s', sid)
        else:
            key = ('a', sid, admission_key(admission))
            coverage.record_fallback(
                'serving', coverage.REASON_ADMISSION_UNENCODABLE)
        ticket = Ticket(
            key=key,
            resource=resource, context=context, pctx=pctx,
            admission=admission, scanner=scanner, policies=policies,
            span=tracing.current_span(), on_shed=self.sheds.record,
            old_resource=old_resource)
        self.queue.put(ticket)
        self._set_depth()
        return ticket

    def record_shed(self, reason: str) -> None:
        self.sheds.record(reason)

    # -- the coalescing loop ----------------------------------------------

    def _loop(self) -> None:
        while True:
            first = self.queue.wait_for_work()
            if first is None:
                return  # stopping and drained
            self.queue.wait_flush(first.key, self.max_batch,
                                  first.enqueued_at + self.window_s)
            batch = self.queue.take_batch(first.key, self.max_batch)
            self._set_depth()
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        t0 = time.monotonic()
        lead = batch[0]
        self._observe(batch, t0)
        from ..observability import provenance
        try:
            self._scan_and_resolve(batch, t0)
        except Exception as e:  # noqa: BLE001 - riders quarantine, never a 500
            resolved, _shed, wholesale = self._quarantine(
                batch, t0, depth=1)
            # the breaker hears at most one verdict per ORIGINAL
            # dispatch: any rider resolving on device proves the
            # backend healthy (the failure was row-local); nothing
            # surviving is a breaker failure only on systemic evidence
            # — a wholesale shed, or the key failing every row of
            # ALL_FAILED_BREAKER_AFTER consecutive dispatches.  An
            # all-poison batch (row-attributed sheds, first strike)
            # stays neutral: no verdict, scanner keeps serving.
            if resolved:
                self._all_failed.pop(lead.key, None)
                if self.on_success is not None:
                    self.on_success(lead.policies)
            else:
                strikes = self._all_failed.get(lead.key, 0) + 1
                self._all_failed[lead.key] = strikes
                while len(self._all_failed) > 512:  # stray-key bound
                    self._all_failed.pop(next(iter(self._all_failed)))
                if (wholesale or strikes >= ALL_FAILED_BREAKER_AFTER) \
                        and self.on_failure is not None:
                    self.on_failure(lead.policies, e)
            # flight-recorder dump last: the riders and the breaker are
            # already notified, so the (file-writing) dump never delays
            # recovery — the ring's history lands on disk next to the
            # failure that triggered this quarantine
            provenance.notify_scan_error(e)
            return
        self._all_failed.pop(lead.key, None)
        if self.on_success is not None:
            self.on_success(lead.policies)

    def _scan_and_resolve(self, batch, t0: float) -> None:
        """One shared device dispatch for ``batch``: scan, fill
        provenance, resolve every rider.  Raises on failure — the
        caller (``_dispatch`` / ``_quarantine``) owns shed and breaker
        accounting.  Quarantine sub-dispatches re-enter here, so the
        fault-injection row check re-fires per sub-batch and bisection
        can isolate marker-poisoned rows."""
        lead = batch[0]
        scanner = lead.scanner
        resources = [t.resource for t in batch]
        contexts = [t.context for t in batch]
        # host materialization must see each request's own
        # PolicyContext; scan hands the factory the resource document,
        # which is this request's freshly parsed dict
        pctx_of = {id(t.resource): t.pctx for t in batch}
        lead_pctx = lead.pctx

        def pctx_factory(doc):
            return pctx_of.get(id(doc), lead_pctx)

        from ..observability import device as devtel
        from ..observability import provenance
        # per-dispatch provenance capture: device_eval time of THIS
        # scan (not a registry-sum delta a concurrent rescan could
        # contaminate) amortizes over the riders as their device share
        cap = devtel.ScanCapture() if provenance.enabled() else None
        # UPDATE rows carry oldObject for the scanner's match retry; the
        # kwarg is only passed when present so CREATE-era scanner
        # doubles (and the mutate scanner) keep their signatures
        extra = {}
        if any(t.old_resource for t in batch):
            extra['old_resources'] = [t.old_resource for t in batch]
        # heterogeneous batches: each rider's own admission tuple rides
        # to the scanner as a per-row column (the scanner-only batch
        # key makes mixed tuples share this dispatch)
        if getattr(scanner, 'supports_row_admissions', False):
            extra['admissions'] = [t.admission for t in batch]
        with devtel.install_capture(cap), \
                tracing.tracer().start_span(
                    'kyverno/serving/batch',
                    {'occupancy': len(batch),
                     'window_ms': self.window_s * 1000.0},
                    parent=lead.span) as bspan:
            faults.check_rows(faults.SITE_BATCHER_DISPATCH, resources)
            rows = scanner.scan(resources, contexts=contexts,
                                admission=lead.admission,
                                pctx_factory=pctx_factory, **extra)
            if cap is not None and cap.critical_path is not None:
                from ..observability import timeline as tlmod
                bspan.set_attribute(
                    'critical_path',
                    tlmod.format_summary(cap.critical_path))
        if cap is not None:
            device_eval_s = cap.stage_s('device_eval')
            share = device_eval_s / len(batch)
            batch_id = provenance.next_batch_id()
            for t in batch:
                # filled before resolve(): the waiting webhook thread
                # reads prov right after its future resolves
                t.prov = {
                    'batch_id': batch_id,
                    'occupancy': len(batch),
                    'queue_wait_s': t0 - t.enqueued_at,
                    'device_share_s': share,
                    'device_eval_s': device_eval_s,
                    'aot_cache': cap.aot,
                    'coverage_ratio': cap.coverage_ratio,
                }
        for t, row in zip(batch, rows):
            t.resolve(row)

    def _shed_batch(self, batch, reason: str) -> None:
        for t in batch:
            t.shed(reason)
            self.sheds.record(reason)
            if reason == shed_policy.REASON_POISON_ROW:
                # the quarantined row is served by the host loop; the
                # coverage ledger attributes that fall like any other
                coverage.record_fallback(
                    'serving', coverage.REASON_POISON_ROW)

    def _quarantine(self, batch, t0: float, depth: int):
        """Bisect a failed dispatch to isolate poison rows.

        Returns ``(resolved, shed, wholesale)`` rider counts, where
        ``wholesale`` is the subset of ``shed`` that is
        infrastructure-shaped evidence: depth-bound groups (shed under
        ``scan_error``, un-isolated) and retry-exhausted pipeline
        failures (shed under ``stage_retry_exhausted``).  A singleton
        gets one solo re-dispatch — transient device errors recover
        with no shed at all — and only a persistently failing row
        sheds, under ``poison_row``; those row-attributed sheds count
        in ``shed`` but never in ``wholesale``, so the caller's breaker
        verdict can tell an unlucky all-poison batch from a broken
        backend, and the poison_row count stays an exact per-row
        signal.
        """
        if depth > QUARANTINE_MAX_DEPTH:
            self._shed_batch(batch, shed_policy.REASON_SCAN_ERROR)
            return 0, len(batch), len(batch)
        with self._stats_lock:
            self._quarantine_dispatches += 1
        if len(batch) == 1:
            try:
                self._scan_and_resolve(batch, t0)
            except Exception as e:  # noqa: BLE001 - row is poison, shed it
                exhausted = getattr(e, 'ktpu_retry_exhausted', False)
                reason = shed_policy.REASON_STAGE_RETRY_EXHAUSTED \
                    if exhausted else shed_policy.REASON_POISON_ROW
                self._shed_batch(batch, reason)
                return 0, 1, (1 if exhausted else 0)
            return 1, 0, 0
        mid = len(batch) // 2
        resolved = shed = wholesale = 0
        for half in (batch[:mid], batch[mid:]):
            try:
                self._scan_and_resolve(half, t0)
                resolved += len(half)
            except Exception:  # noqa: BLE001 - keep bisecting this half
                r, s, w = self._quarantine(half, t0, depth + 1)
                resolved += r
                shed += s
                wholesale += w
        return resolved, shed, wholesale

    # -- telemetry ---------------------------------------------------------

    def _registry(self) -> Optional[MetricsRegistry]:
        registry = global_registry()
        if registry is not None and registry is not self._registered_on:
            # bucket overrides must land before the first observe; the
            # calls are no-ops once each histogram exists
            registry.register_histogram(BATCH_OCCUPANCY,
                                        OCCUPANCY_BUCKETS)
            registry.register_histogram(HETERO_OCCUPANCY,
                                        OCCUPANCY_BUCKETS)
            registry.register_histogram(QUEUE_WAIT, WAIT_BUCKETS)
            # queue depth is a residency gauge: a drained server must
            # export 0 (swept by cmd/internal.Setup.shutdown)
            registry.mark_reset_on_close(QUEUE_DEPTH)
            self._registered_on = registry
        return registry

    def _set_depth(self) -> None:
        registry = self._registry()
        if registry is not None:
            registry.set_gauge(QUEUE_DEPTH, self.queue.depth())

    def _observe(self, batch, t0: float) -> None:
        waits = [t0 - t.enqueued_at for t in batch]
        # heterogeneous = the riders carry >1 distinct canonical
        # admission tuple; production telemetry must distinguish this
        # coalescing regime from same-tuple (homogeneous) batching
        hetero = len(batch) > 1 and \
            len({admission_key(t.admission) for t in batch}) > 1
        with self._stats_lock:
            self._dispatches += 1
            self._requests += len(batch)
            self._occupancies.append(len(batch))
            if hetero:
                self._hetero_dispatches += 1
                self._hetero_occupancies.append(len(batch))
            self._waits_s.extend(waits)
        registry = self._registry()
        if registry is not None:
            registry.observe(BATCH_OCCUPANCY, float(len(batch)))
            if hetero:
                registry.observe(HETERO_OCCUPANCY, float(len(batch)))
            for w in waits:
                registry.observe(QUEUE_WAIT, w)

    @staticmethod
    def _p50(values) -> float:
        data = sorted(values)
        return data[len(data) // 2] if data else 0.0

    def stats(self) -> Dict[str, object]:
        """Local counters for benchmarks/tests (no registry needed)."""
        with self._stats_lock:
            occ = list(self._occupancies)
            hocc = list(self._hetero_occupancies)
            waits = list(self._waits_s)
            dispatches = self._dispatches
            hetero = self._hetero_dispatches
            requests = self._requests
            quarantine = self._quarantine_dispatches
        return {
            'dispatches': dispatches,
            'quarantine_dispatches': quarantine,
            'requests': requests,
            'occupancy_mean': (sum(occ) / len(occ)) if occ else 0.0,
            'occupancy_p50': self._p50(occ),
            'hetero_dispatches': hetero,
            'hetero_occupancy_mean': (sum(hocc) / len(hocc))
            if hocc else 0.0,
            'queue_wait_p50_ms': self._p50(waits) * 1000.0,
            'shed_total': self.sheds.total(),
            'shed': self.sheds.counts(),
            'queue_depth': self.queue.depth(),
        }

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._occupancies.clear()
            self._hetero_occupancies.clear()
            self._waits_s.clear()
            self._dispatches = 0
            self._hetero_dispatches = 0
            self._requests = 0
            self._quarantine_dispatches = 0
        self.sheds.reset()

    # -- lifecycle ---------------------------------------------------------

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop.  ``drain=True`` (shutdown path) dispatches
        every pending ticket first — their waiting webhook threads get
        real batched responses; ``drain=False`` sheds them to the host
        loop immediately."""
        if self._stopped:
            return
        self._stopped = True
        if not drain:
            for t in self.queue.take_all():
                t.shed(shed_policy.REASON_SHUTDOWN)
                self.sheds.record(shed_policy.REASON_SHUTDOWN)
        self.queue.stop()
        self._thread.join(timeout=timeout)
