"""Degradation policy for the admission micro-batcher.

A request leaves the batched fast path for exactly one of the reasons
below; every shed is counted (locally for ``stats()`` consumers and on
``kyverno_tpu_admission_shed_total{reason}`` when a metrics registry is
configured).  Shedding is never an error to the API server: the webhook
thread that owns the request runs the host engine loop instead —
identical verdicts, honoring the webhook failurePolicy semantics the
sync path already provides.

Accounting discipline: each reason is recorded exactly once, at the
site that makes the shed decision — ``queue_full`` / ``shutdown`` by
the submitting handler (the ticket never entered the queue or the
batcher is stopping without drain), ``deadline`` by the waiting webhook
thread when its compare-and-set from PENDING wins, ``poison_row`` /
``stage_retry_exhausted`` by the batcher's quarantine per ISOLATED row
(never per batch), ``scan_error`` by the batcher only for a group
still failing wholesale at the quarantine depth bound, and
``breaker_open`` by the validating handler when the policy set's
circuit breaker quarantined it to the host loop before a ticket could
even be submitted.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..observability.metrics import global_registry

#: the bounded queue was at capacity when the request arrived
REASON_QUEUE_FULL = 'queue_full'
#: the request's future did not resolve within the effective deadline
#: (KTPU_SHED_DEADLINE_MS, tightened by the review's own timeoutSeconds)
REASON_DEADLINE = 'deadline'
#: a quarantined group still failed wholesale at the bisection depth
#: bound — un-isolated riders shed together
REASON_SCAN_ERROR = 'scan_error'
#: the batcher is stopped (post-drain submits)
REASON_SHUTDOWN = 'shutdown'
#: quarantine bisection isolated THIS row as the one poisoning its
#: shared dispatch; healthy riders stayed on device
REASON_POISON_ROW = 'poison_row'
#: the policy set's circuit breaker is open (or this caller lost the
#: half-open probe slot): host loop without entering the queue
REASON_BREAKER_OPEN = 'breaker_open'
#: the isolated row's dispatch died on a scan-pipeline stage that
#: burned its whole KTPU_STAGE_RETRIES budget
REASON_STAGE_RETRY_EXHAUSTED = 'stage_retry_exhausted'

REASONS = (REASON_QUEUE_FULL, REASON_DEADLINE, REASON_SCAN_ERROR,
           REASON_SHUTDOWN, REASON_POISON_ROW, REASON_BREAKER_OPEN,
           REASON_STAGE_RETRY_EXHAUSTED)

ADMISSION_SHED = 'kyverno_tpu_admission_shed_total'


class ShedLedger:
    """Thread-safe per-reason shed counters.

    Mirrors every count onto the process metrics registry when one is
    configured; keeps local totals either way so benchmarks and tests
    can read shed traffic without wiring a registry.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def record(self, reason: str) -> None:
        with self._lock:
            self._counts[reason] = self._counts.get(reason, 0) + 1
        registry = global_registry()
        if registry is not None:
            registry.inc(ADMISSION_SHED, reason=reason)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
