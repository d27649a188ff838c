"""Serving SLO engine: sliding-window burn rate on admission latency.

The admission path has latency histograms but no *objective*: nothing
in the process knows whether p99 is inside budget, so regressions are
found by reading dashboards after the fact.  This module attaches the
objective (`KTPU_SLO_P99_MS` at quantile `KTPU_SLO_TARGET`) and
computes **multi-window burn rate** over a sliding time window
(`KTPU_SLO_WINDOW_S`), the SRE alerting construct: with error budget
``1 - target``, ``burn = error_rate / (1 - target)`` — burn 1.0 spends
exactly the budget over the window, burn N spends it N× too fast.  The
degraded verdict requires BOTH the long window (the full
``KTPU_SLO_WINDOW_S``) and a short window (one ring slice,
``window / 12``) to burn past :data:`BURN_DEGRADED`, so a single slow
decision cannot flap the verdict and a recovered server clears it
within one slice.

Implementation: a fixed-bucket latency digest sliced over a time ring —
``SLICES`` slices each covering ``window / SLICES`` seconds, per
serving path (``batch | sync | shed | host_fallback``).  ``record``
lands a decision in the current slice (O(buckets)); reads sum the
slices still inside the window.  No dependencies, bounded memory
(slices × paths × buckets counters).

Exports: ``kyverno_tpu_slo_burn_rate{window=short|long}`` and
``kyverno_tpu_slo_budget_remaining`` gauges, ``GET /debug/slo``, and
the verdict folded into the webhook ``GET /health`` payload.  When the
degraded transition fires, an **auto-profile** captures a deep profile
once, rate-limited (:data:`PROFILE_MIN_INTERVAL_S`), through
``observability.profiling.deep_profile`` — the same auto-capture
pattern as the d2h stall watchdog's flight-recorder dump, giving every
burn alert a flamegraph of what the server was doing as it crossed.

Off by default: ``KTPU_SLO_WINDOW_S=0`` (the shipped default) makes
every hook a no-op and the admission path bit-identical, pinned by
``tests/test_slo.py``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import MetricsRegistry, global_registry

SLO_BURN_RATE = 'kyverno_tpu_slo_burn_rate'
SLO_BUDGET_REMAINING = 'kyverno_tpu_slo_budget_remaining'

#: latency bucket bounds, milliseconds — spans sub-ms cache replays to
#: the host-loop sweeps of 1k-policy sets
BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0)

#: time slices per window: reads sum full slices, so resolution is
#: window/12 and the short burn window is exactly one slice
SLICES = 12

#: burn rate at which the verdict degrades (both windows must cross);
#: 1.0 = spending the error budget exactly at the sustainable rate
BURN_DEGRADED = 1.0

#: floor between auto-profile captures (per process)
PROFILE_MIN_INTERVAL_S = 60.0

_DEFAULT_P99_MS = 500.0
_DEFAULT_TARGET = 0.99

_log = logging.getLogger('kyverno.slo')


def _to_float(raw: Optional[str], default: float) -> float:
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class SloEngine:
    """Sliding-window latency digests + burn-rate computation.

    ``now`` is injectable (tests drive synthetic clocks); defaults to
    ``time.monotonic`` — wall-clock jumps must not spill slices."""

    def __init__(self, window_s: float, p99_ms: float, target: float,
                 registry: Optional[MetricsRegistry] = None,
                 now: Callable[[], float] = time.monotonic,
                 profile_trigger: Optional[Callable[[], Any]] = None):
        self.window_s = window_s
        self.objective_ms = p99_ms
        self.target = min(max(target, 0.0), 0.9999)
        self.registry = registry
        self.now = now
        self.profile_trigger = profile_trigger
        self.slice_s = window_s / SLICES
        self._lock = threading.Lock()
        # ring: SLICES entries of {path: [count, over, bucket_counts]},
        # each stamped with the absolute slice epoch it covers so stale
        # slices are recognized lazily instead of swept by a thread
        self._slices: List[Dict[str, List[Any]]] = \
            [{} for _ in range(SLICES)]
        self._epochs: List[int] = [-1] * SLICES
        self._degraded = False
        self._last_profile = float('-inf')
        self.auto_profiles = 0

    # -- writes ------------------------------------------------------------

    def record(self, path: str, duration_s: float) -> None:
        ms = duration_s * 1000.0
        epoch = int(self.now() / self.slice_s)
        idx = epoch % SLICES
        with self._lock:
            if self._epochs[idx] != epoch:
                self._slices[idx] = {}
                self._epochs[idx] = epoch
            entry = self._slices[idx].get(path)
            if entry is None:
                entry = [0, 0, [0] * (len(BUCKETS_MS) + 1)]
                self._slices[idx][path] = entry
            entry[0] += 1
            if ms > self.objective_ms:
                entry[1] += 1
            for i, bound in enumerate(BUCKETS_MS):
                if ms <= bound:
                    entry[2][i] += 1
                    break
            else:
                entry[2][len(BUCKETS_MS)] += 1
            burn_short, burn_long, remaining = self._burn_locked(epoch)
            degraded = burn_short >= BURN_DEGRADED and \
                burn_long >= BURN_DEGRADED
            crossed = degraded and not self._degraded
            self._degraded = degraded
        self._publish(burn_short, burn_long, remaining)
        if crossed:
            self._auto_profile(burn_short, burn_long)

    # -- burn math ---------------------------------------------------------

    def _window_totals(self, epoch: int, n_slices: int,
                       by_path: Optional[Dict[str, List[Any]]] = None
                       ) -> tuple:
        """(count, over) across the ``n_slices`` most recent slices
        (inclusive of the current one).  Called under the lock."""
        count = over = 0
        for back in range(n_slices):
            want = epoch - back
            if want < 0:
                break
            idx = want % SLICES
            if self._epochs[idx] != want:
                continue  # stale or never-filled slice
            for path, entry in self._slices[idx].items():
                count += entry[0]
                over += entry[1]
                if by_path is not None:
                    agg = by_path.setdefault(
                        path, [0, 0, [0] * (len(BUCKETS_MS) + 1)])
                    agg[0] += entry[0]
                    agg[1] += entry[1]
                    for i, b in enumerate(entry[2]):
                        agg[2][i] += b
        return count, over

    def _burn_locked(self, epoch: int) -> tuple:
        """(burn_short, burn_long, budget_remaining); under the lock."""
        budget = 1.0 - self.target
        l_count, l_over = self._window_totals(epoch, SLICES)
        s_count, s_over = self._window_totals(epoch, 1)
        burn_long = (l_over / l_count) / budget if l_count else 0.0
        burn_short = (s_over / s_count) / budget if s_count else 0.0
        remaining = 1.0 - burn_long
        return burn_short, burn_long, remaining

    def _publish(self, burn_short: float, burn_long: float,
                 remaining: float) -> None:
        reg = self.registry or global_registry()
        if reg is None:
            return
        # burn rate is a live condition of THIS process — a drained
        # server must export 0, not its last degraded sample
        reg.mark_reset_on_close(SLO_BURN_RATE)
        reg.mark_reset_on_close(SLO_BUDGET_REMAINING)
        reg.set_gauge(SLO_BURN_RATE, round(burn_short, 6), window='short')
        reg.set_gauge(SLO_BURN_RATE, round(burn_long, 6), window='long')
        reg.set_gauge(SLO_BUDGET_REMAINING, round(remaining, 6))

    # -- auto-profile ------------------------------------------------------

    def _auto_profile(self, burn_short: float, burn_long: float) -> None:
        """Degraded transition: capture one deep profile (py sampler +
        jax trace when a backend is live), rate-limited so a flapping
        burn cannot stack captures.  Runs on a daemon thread — the
        observing request never waits on the capture."""
        now = self.now()
        with self._lock:
            if now - self._last_profile < PROFILE_MIN_INTERVAL_S:
                return
            self._last_profile = now
            self.auto_profiles += 1
        trigger = self.profile_trigger
        if trigger is None:
            from . import profiling

            def trigger():
                return profiling.deep_profile(seconds=2.0,
                                              trigger='slo_burn')
        _log.error(
            'SLO burn-rate degraded (short=%.2f long=%.2f, objective '
            'p%g<=%.0fms over %.0fs): capturing auto-profile',
            burn_short, burn_long, self.target * 100,
            self.objective_ms, self.window_s)

        def work():
            try:
                trigger()
            except Exception:  # noqa: BLE001 - capture is best-effort
                _log.exception('slo auto-profile capture failed')

        threading.Thread(target=work, name='ktpu-slo-profile',
                         daemon=True).start()

    # -- reads -------------------------------------------------------------

    def verdict(self) -> Dict[str, Any]:
        """The compact health view folded into ``GET /health``."""
        with self._lock:
            epoch = int(self.now() / self.slice_s)
            burn_short, burn_long, remaining = self._burn_locked(epoch)
            degraded = self._degraded
        return {
            'degraded': degraded,
            'burn_rate_short': round(burn_short, 4),
            'burn_rate_long': round(burn_long, 4),
            'budget_remaining': round(remaining, 4),
            'objective_ms': self.objective_ms,
            'target': self.target,
            'window_s': self.window_s,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/slo`` body: the verdict plus per-path digests
        (count, over-objective count, estimated p50/p99 from the
        fixed buckets) over the long window."""
        by_path: Dict[str, List[Any]] = {}
        with self._lock:
            epoch = int(self.now() / self.slice_s)
            self._window_totals(epoch, SLICES, by_path=by_path)
        paths = {}
        for path, (count, over, buckets) in sorted(by_path.items()):
            paths[path] = {
                'count': count,
                'over_objective': over,
                'p50_ms': _bucket_quantile(buckets, 0.50),
                'p99_ms': _bucket_quantile(buckets, 0.99),
            }
        out = self.verdict()
        out['auto_profiles'] = self.auto_profiles
        out['paths'] = paths
        return out


def _bucket_quantile(buckets: List[int], q: float) -> float:
    """Upper-bound estimate of the ``q`` quantile from fixed-bucket
    counts (the bound of the bucket the quantile falls in; the overflow
    bucket reports the largest finite bound)."""
    total = sum(buckets)
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, n in enumerate(buckets):
        seen += n
        if seen >= rank and n:
            return BUCKETS_MS[i] if i < len(BUCKETS_MS) \
                else BUCKETS_MS[-1]
    return BUCKETS_MS[-1]


# -- module state -----------------------------------------------------------

_engine: Optional[SloEngine] = None


def configure(registry: Optional[MetricsRegistry] = None,
              window_s: Optional[float] = None,
              p99_ms: Optional[float] = None,
              target: Optional[float] = None,
              now: Callable[[], float] = time.monotonic,
              profile_trigger: Optional[Callable[[], Any]] = None
              ) -> Optional[SloEngine]:
    """Enable the SLO engine.  ``window_s`` defaults to
    ``KTPU_SLO_WINDOW_S`` (0, the shipped default, disables entirely —
    the off state the bit-identity tests pin against); the objective
    defaults to ``KTPU_SLO_P99_MS`` at quantile ``KTPU_SLO_TARGET``.
    Idempotent; :func:`disable` undoes it."""
    global _engine
    if window_s is None:
        window_s = _to_float(os.environ.get('KTPU_SLO_WINDOW_S'), 0.0)
    if window_s <= 0:
        disable()
        return None
    if p99_ms is None:
        p99_ms = _to_float(os.environ.get('KTPU_SLO_P99_MS'),
                           _DEFAULT_P99_MS)
    if target is None:
        target = _to_float(os.environ.get('KTPU_SLO_TARGET'),
                           _DEFAULT_TARGET)
    _engine = SloEngine(
        window_s=window_s, p99_ms=p99_ms, target=target,
        registry=registry or global_registry(), now=now,
        profile_trigger=profile_trigger)
    return _engine


def disable() -> None:
    global _engine
    _engine = None


def engine() -> Optional[SloEngine]:
    return _engine


def enabled() -> bool:
    """The zero-overhead gate the admission path checks (one global
    read)."""
    return _engine is not None


def record(path: str, duration_s: float) -> None:
    """Feed one admission decision (no-op when unconfigured).
    ``shed:<reason>`` paths fold to ``shed`` — the SLO tracks the
    serving lane, the shed taxonomy lives on
    ``kyverno_tpu_admission_shed_total``."""
    eng = _engine
    if eng is not None:
        eng.record(path.split(':', 1)[0], duration_s)


def verdict() -> Optional[Dict[str, Any]]:
    """Health-payload verdict, or None when unconfigured."""
    eng = _engine
    return eng.verdict() if eng is not None else None


def snapshot() -> Dict[str, Any]:
    """Bench / endpoint view (empty when unconfigured)."""
    eng = _engine
    return eng.snapshot() if eng is not None else {}
