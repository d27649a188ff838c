"""Bounded admission request queue with per-request futures.

Each webhook thread submits a :class:`Ticket` (its scan inputs plus a
future) and blocks on :meth:`Ticket.wait`; the batcher thread claims
runs of same-key tickets and resolves their futures with the rows of
one shared device dispatch.

Ownership of a ticket is decided by a compare-and-set on its state
under the ticket lock: the batcher moves PENDING → CLAIMED when it
takes a batch, the waiting webhook thread moves PENDING → SHED when its
deadline blows.  Exactly one side wins, so a request is either answered
by the batch it rode or re-run on the host engine loop — never both,
never neither.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional

from . import shed as shed_policy

#: ticket states (see module docstring for the ownership protocol)
PENDING = 'pending'
CLAIMED = 'claimed'
SHED = 'shed'
DONE = 'done'


class QueueFull(Exception):
    """The bounded admission queue is at capacity (shed to host)."""


class Stopped(Exception):
    """The batcher is stopped; no new tickets (shed to host)."""


class Ticket:
    """One queued admission scan: inputs + the future its webhook
    thread blocks on.

    ``key`` groups coalescible requests — the compiled scanner's
    monotonic serial alone for scanners that consume per-row admission
    tuples (mixed users/roles/namespaces/verbs share one dispatch,
    bit-identical to each request's own sync scan because the scanner
    threads each row's tuple through the match pipeline), or serial +
    the canonical admission tuple on the residual path for scanners
    without per-row support.  ``on_shed`` is the batcher's shed ledger;
    the deadline shed is recorded here because the waiting thread, not
    the batcher, makes that decision.
    """

    __slots__ = ('key', 'resource', 'context', 'pctx', 'admission',
                 'scanner', 'policies', 'span', 'on_shed', 'enqueued_at',
                 'state', 'responses', 'shed_reason', 'prov',
                 'old_resource', '_lock', '_event')

    def __init__(self, key, resource: dict, context: Optional[dict],
                 pctx, admission: tuple, scanner, policies,
                 span=None, on_shed=None,
                 old_resource: Optional[dict] = None):
        self.key = key
        self.resource = resource
        self.context = context
        #: UPDATE-verb rows ride their oldObject along for the scanner's
        #: old-match retry; None on CREATE / mutate tickets
        self.old_resource = old_resource
        self.pctx = pctx
        self.admission = admission
        self.scanner = scanner
        self.policies = policies
        self.span = span
        self.on_shed = on_shed
        self.enqueued_at = time.monotonic()
        self.state = PENDING
        self.responses: Optional[list] = None
        self.shed_reason: Optional[str] = None
        #: decision-provenance fields the batcher fills at dispatch
        #: (batch id, occupancy, queue wait, amortized device share);
        #: the waiting webhook thread folds them into its
        #: DecisionRecord after resolve
        self.prov: Optional[dict] = None
        self._lock = threading.Lock()
        self._event = threading.Event()

    # -- batcher side -----------------------------------------------------

    def claim(self) -> bool:
        """PENDING → CLAIMED; False when the waiter already shed."""
        with self._lock:
            if self.state == PENDING:
                self.state = CLAIMED
                return True
            return False

    def resolve(self, responses: list) -> None:
        with self._lock:
            self.state = DONE
            self.responses = responses
        self._event.set()

    def shed(self, reason: str) -> None:
        """Terminal shed by the batcher (scan failure / shutdown)."""
        with self._lock:
            self.state = SHED
            self.shed_reason = reason
        self._event.set()

    # -- webhook-thread side ----------------------------------------------

    def _try_shed(self, reason: str) -> bool:
        with self._lock:
            if self.state == PENDING:
                self.state = SHED
                self.shed_reason = reason
                return True
            return False

    def wait(self, shed_after_s: float,
             claimed_timeout_s: float = 60.0) -> Optional[list]:
        """Block for the batched responses.

        Returns the per-policy response list, or None when the request
        shed to the host engine loop (``shed_reason`` says why).  A
        ticket already CLAIMED at the deadline has a dispatch in flight
        — the result is seconds away at worst, so waiting beats
        double-running the scan; ``claimed_timeout_s`` only bounds a
        wedged dispatch.
        """
        if not self._event.wait(shed_after_s):
            if self._try_shed(shed_policy.REASON_DEADLINE):
                if self.on_shed is not None:
                    self.on_shed(shed_policy.REASON_DEADLINE)
                return None
            self._event.wait(claimed_timeout_s)
        with self._lock:
            return self.responses if self.state == DONE else None


class RequestQueue:
    """Bounded FIFO of tickets with flush-condition waits.

    The deque holds tickets in arrival order; non-PENDING entries
    (deadline-shed by their waiters) are pruned during scans.  All
    waits ride one condition variable, notified on put and stop, so
    the batcher reacts to occupancy without polling.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._stopping = False

    def put(self, ticket: Ticket) -> None:
        with self._cond:
            if self._stopping:
                raise Stopped()
            if len(self._items) >= self.capacity:
                # only live tickets count against capacity
                self._items = deque(
                    t for t in self._items if t.state == PENDING)
                if len(self._items) >= self.capacity:
                    raise QueueFull()
            self._items.append(ticket)
            self._cond.notify_all()

    def wait_for_work(self) -> Optional[Ticket]:
        """Block until a PENDING ticket exists; None once stopping with
        an empty queue (the drain is complete)."""
        with self._cond:
            while True:
                for t in self._items:
                    if t.state == PENDING:
                        return t
                if self._stopping:
                    return None
                self._cond.wait()

    def wait_flush(self, key: Any, max_batch: int,
                   deadline: float) -> None:
        """Block until ``key`` reaches ``max_batch`` pending tickets,
        the deadline passes, or the queue is stopping (drain flushes
        immediately)."""
        with self._cond:
            while not self._stopping:
                n = sum(1 for t in self._items
                        if t.state == PENDING and t.key == key)
                if n >= max_batch:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._cond.wait(remaining)

    def take_batch(self, key: Any, max_batch: int) -> List[Ticket]:
        """Claim and remove up to ``max_batch`` PENDING tickets of
        ``key`` (FIFO); prunes dead tickets encountered on the way."""
        with self._cond:
            batch: List[Ticket] = []
            keep: deque = deque()
            for t in self._items:
                if t.state != PENDING:
                    continue
                if t.key == key and len(batch) < max_batch and t.claim():
                    batch.append(t)
                else:
                    keep.append(t)
            self._items = keep
            self._cond.notify_all()
            return batch

    def take_all(self) -> List[Ticket]:
        """Claim and remove every pending ticket (no-drain shutdown)."""
        with self._cond:
            batch = [t for t in self._items if t.claim()]
            self._items.clear()
            self._cond.notify_all()
            return batch

    def depth(self) -> int:
        with self._cond:
            return sum(1 for t in self._items if t.state == PENDING)

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
