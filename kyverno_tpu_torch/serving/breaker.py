"""Per-policy-set circuit breakers with half-open recovery.

Replaces the permanent ``_dead_keys`` trip in ``webhooks/handlers.py``
with a closed → open → half-open state machine:

* **closed** — device path serves; failures count toward the limit.
* **open** — the set is quarantined to the host engine loop for an
  exponential backoff window (``KTPU_BREAKER_BACKOFF_MS`` base,
  doubling per trip up to ``KTPU_BREAKER_BACKOFF_MAX_MS``, plus a
  deterministic per-(key, trip) jitter fraction so many sets tripped
  by one systemic event don't re-probe in lockstep).
* **half-open** — the backoff elapsed: exactly ONE request per window
  is admitted as a probe (``allow`` returns :data:`PROBE`); everyone
  else keeps shedding to the host loop.  A probe success closes the
  breaker and re-admits the set to the device path; a probe failure
  re-opens it with a doubled backoff.

The registry is bounded (``KTPU_BREAKER_CAP``).  Evicting an entry
forgets breaker state — under many policy sets that can silently
re-admit a broken backend — so every eviction counts on
``kyverno_tpu_breaker_evictions_total`` and closed entries are evicted
before tripped ones.  State is exported as the
``kyverno_tpu_breaker_state{state}`` gauge and as JSON on the profile
server's ``GET /debug/breakers``.

The clock is injectable so tests drive the full open → half-open →
closed round trip without sleeping.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ..observability.metrics import global_registry

BREAKER_STATE = 'kyverno_tpu_breaker_state'
BREAKER_EVICTIONS = 'kyverno_tpu_breaker_evictions_total'

#: breaker states (also the ``allow`` decisions; PROBE is the
#: half-open decision handed to exactly one caller per window)
CLOSED = 'closed'
OPEN = 'open'
HALF_OPEN = 'half_open'
PROBE = 'probe'

STATES = (CLOSED, OPEN, HALF_OPEN)

#: deterministic jitter fraction added on top of the exponential
#: backoff (scaled by a per-(key, trips) hash in [0, 1))
JITTER = 0.2


def breaker_cap() -> int:
    try:
        return max(1, int(os.environ.get('KTPU_BREAKER_CAP', '64')))
    except ValueError:
        return 64


def base_backoff_s() -> float:
    try:
        return max(0.001, float(os.environ.get(
            'KTPU_BREAKER_BACKOFF_MS', '1000')) / 1000.0)
    except ValueError:
        return 1.0


def max_backoff_s() -> float:
    try:
        return max(0.001, float(os.environ.get(
            'KTPU_BREAKER_BACKOFF_MAX_MS', '60000')) / 1000.0)
    except ValueError:
        return 60.0


class _Entry:
    __slots__ = ('state', 'failures', 'policies', 'opened_at',
                 'backoff_s', 'trips', 'probe_inflight', 'probe_at',
                 'last_error')

    def __init__(self, policies):
        self.state = CLOSED
        self.failures = 0
        # pin the policy objects while counted: the key is a tuple of
        # id()s, so CPython id reuse after GC must be impossible
        self.policies = list(policies)
        self.opened_at = 0.0
        self.backoff_s = 0.0
        self.trips = 0
        self.probe_inflight = False
        self.probe_at = 0.0
        self.last_error = ''


#: live registries, for /debug/breakers aggregation (weak: a handler
#: teardown drops its registry from the debug view automatically)
_DEBUG: 'weakref.WeakSet[BreakerRegistry]' = weakref.WeakSet()


def debug_report() -> dict:
    """Aggregate JSON body for ``GET /debug/breakers``."""
    regs = [r for r in list(_DEBUG)]
    return {
        'enabled': bool(regs),
        'breakers': [item for r in regs for item in r.report()],
    }


class BreakerRegistry:
    """Keyed breaker states behind one lock.

    ``on_open(open_count)`` fires (outside the lock) whenever a trip
    raises the number of simultaneously open breakers — the handlers
    layer uses it for the systemic global device disable.
    """

    def __init__(self, failure_limit: int = 3,
                 cap: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 base_s: Optional[float] = None,
                 max_s: Optional[float] = None,
                 on_open: Optional[Callable[[int], None]] = None):
        self.failure_limit = max(1, failure_limit)
        self.cap = cap if cap is not None else breaker_cap()
        self.clock = clock
        self.base_s = base_s if base_s is not None else base_backoff_s()
        self.max_s = max_s if max_s is not None else max_backoff_s()
        self.on_open = on_open
        self._entries: 'OrderedDict[tuple, _Entry]' = OrderedDict()
        self._lock = threading.Lock()
        _DEBUG.add(self)

    # -- internals (lock held) --------------------------------------------

    def _backoff(self, key, trips: int) -> float:
        base = min(self.max_s, self.base_s * (2.0 ** max(0, trips - 1)))
        # tuple-of-int keys hash deterministically within a process, so
        # the jitter is stable per (key, trip) — replayable in tests —
        # while still de-synchronizing distinct sets
        frac = (hash((key, trips)) & 0xFFFF) / float(0xFFFF)
        return base * (1.0 + JITTER * frac)

    def _trip(self, key, entry: _Entry) -> None:
        entry.trips += 1
        entry.state = OPEN
        entry.opened_at = self.clock()
        entry.backoff_s = self._backoff(key, entry.trips)
        entry.probe_inflight = False

    def _evict_for_cap(self) -> None:
        registry = global_registry()
        while len(self._entries) >= self.cap:
            # evict closed (merely counting) entries before tripped
            # ones: forgetting an OPEN breaker re-admits a broken
            # backend, so it is the last thing to go — and either way
            # the eviction is counted, never silent
            victim = None
            for k, e in self._entries.items():
                if e.state == CLOSED:
                    victim = k
                    break
            if victim is None:
                victim = next(iter(self._entries))
            self._entries.pop(victim)
            if registry is not None:
                registry.inc(BREAKER_EVICTIONS)

    def _emit_states(self) -> None:
        registry = global_registry()
        if registry is None:
            return
        # breaker occupancy is a residency gauge: after shutdown the
        # sweep (cmd/internal.Setup.shutdown) zeroes every state series
        registry.mark_reset_on_close(BREAKER_STATE)
        counts = {s: 0 for s in STATES}
        for e in self._entries.values():
            counts[e.state] += 1
        for s, n in counts.items():
            registry.set_gauge(BREAKER_STATE, float(n), state=s)

    # -- decisions ---------------------------------------------------------

    def allow(self, key) -> str:
        """Admission decision for ``key``: :data:`CLOSED` (device
        path), :data:`OPEN` (host loop), or :data:`PROBE` (this caller
        is the single half-open probe)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.state == CLOSED:
                return CLOSED
            if entry.state == OPEN:
                if self.clock() - entry.opened_at < entry.backoff_s:
                    return OPEN
                entry.state = HALF_OPEN
                entry.probe_inflight = True
                entry.probe_at = self.clock()
                self._emit_states()
                return PROBE
            # half-open: one probe per backoff-sized window.  A probe
            # whose request never reported back (shed before dispatch,
            # caller died) must not wedge the breaker: after a full
            # window with no verdict the slot re-opens
            if not entry.probe_inflight or \
                    self.clock() - entry.probe_at >= entry.backoff_s:
                entry.probe_inflight = True
                entry.probe_at = self.clock()
                return PROBE
            return OPEN

    def probe_abort(self, key) -> None:
        """The probe slot's caller could not actually run a request
        (scanner still building): release the slot so the next caller
        re-probes instead of the window wedging."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.state == HALF_OPEN:
                entry.probe_inflight = False

    def state(self, key) -> str:
        with self._lock:
            entry = self._entries.get(key)
            return entry.state if entry is not None else CLOSED

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.state != CLOSED)

    # -- outcomes ----------------------------------------------------------

    def record_failure(self, key, policies, error: str = '') -> str:
        """One device failure for ``key``; returns the state after.
        Fires ``on_open`` (outside the lock) on a trip."""
        opened: Optional[int] = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._evict_for_cap()
                entry = _Entry(policies)
                self._entries[key] = entry
            entry.failures += 1
            entry.last_error = str(error)[:200]
            if entry.state == HALF_OPEN:
                # the probe failed: back to open, doubled backoff
                self._trip(key, entry)
            elif entry.state == CLOSED and \
                    entry.failures >= self.failure_limit:
                self._trip(key, entry)
            if entry.state == OPEN and entry.trips == 1 and \
                    entry.failures == self.failure_limit:
                opened = sum(1 for e in self._entries.values()
                             if e.state != CLOSED)
            self._emit_states()
            state = entry.state
        if opened is not None and self.on_open is not None:
            self.on_open(opened)
        return state

    def migrate(self, old_key, new_key, policies=None) -> str:
        """Carry breaker state from a retired scanner key to its
        successor (scanner hot-swap: same logical policy set, new
        compiled serial).  Without this a swap silently forgives an
        open breaker — the recompiled set would re-enter the device
        path with a clean slate while the backend fault that tripped it
        may still be live.  The entry moves verbatim (state, failure
        count, trips, backoff clock); ``policies`` re-pins the entry on
        the successor's policy objects so the id()-tuple key stays
        collision-safe.  Returns the migrated state (:data:`CLOSED`
        when there was nothing to carry)."""
        with self._lock:
            entry = self._entries.pop(old_key, None)
            if entry is None:
                return CLOSED
            if policies is not None:
                entry.policies = list(policies)
            # an in-flight probe belonged to the retired scanner; the
            # successor's first allow() re-probes on its own clock
            entry.probe_inflight = False
            self._entries[new_key] = entry
            self._emit_states()
            return entry.state

    def record_success(self, key) -> None:
        """One device success for ``key``: closes a half-open breaker
        (recovery — the set is re-admitted to the device path) and
        forgets a closed entry's failure count."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            # success in any state proves the backend serves this set
            # again: drop the entry entirely, unpinning its policies
            self._entries.pop(key, None)
            self._emit_states()

    # -- introspection -----------------------------------------------------

    def report(self) -> List[dict]:
        """Per-key rows for ``/debug/breakers``."""
        now = self.clock()
        with self._lock:
            items: List[Tuple[tuple, _Entry]] = list(self._entries.items())
        rows = []
        for key, e in items:
            names = []
            for p in e.policies:
                name = getattr(p, 'name', None)
                names.append(str(name) if name else type(p).__name__)
            row: Dict[str, object] = {
                'key': repr(key),
                'policies': names,
                'state': e.state,
                'failures': e.failures,
                'trips': e.trips,
                'probe_inflight': e.probe_inflight,
                'last_error': e.last_error,
            }
            if e.state == OPEN:
                row['reopens_in_s'] = round(
                    max(0.0, e.opened_at + e.backoff_s - now), 3)
            rows.append(row)
        return rows
