"""Metrics instruments with Prometheus text exposition.

Mirrors the reference's OTel instrument set (reference:
pkg/metrics/metrics.go:91-224 — kyverno_policy_results_total,
kyverno_policy_execution_duration_seconds, kyverno_policy_changes_total,
kyverno_admission_review_duration_seconds, kyverno_client_queries_total)
without external dependencies: counters and histograms keyed by label
tuples, rendered in Prometheus text format for a /metrics endpoint.
Per-metric disable/relabel follows the dynamic metrics configuration
(reference: pkg/config/metricsconfig.go).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                    2.5, 5.0, 10.0)

#: overflow counter of the label-cardinality guard (KTPU_METRIC_SERIES_MAX)
SERIES_DROPPED = 'kyverno_tpu_metric_series_dropped_total'


def _series_max() -> int:
    try:
        return int(os.environ.get('KTPU_METRIC_SERIES_MAX', '512'))
    except ValueError:
        return 512

#: compile/scan-scale buckets: fresh-cache policy-set compiles measure
#: 43-49s (STATUS.md) — the default buckets top out at 10s and every
#: compile sample would land in +Inf
WIDE_BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
                30.0, 60.0, 120.0)


class MetricsRegistry:
    def __init__(self, disabled: Optional[List[str]] = None):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[Tuple, float]] = {}
        self._gauges: Dict[str, Dict[Tuple, float]] = {}
        self._hists: Dict[str, Dict[Tuple, List]] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._disabled = set(disabled or [])
        self._reset_on_close: set = set()
        # label-cardinality guard: per-host/per-shard labels under a
        # large fleet must not explode the registry, so a metric caps
        # out at this many distinct label-sets — existing series keep
        # updating, NEW series beyond the cap are refused and counted
        self._series_cap = _series_max()

    def _admit(self, store: Dict[str, Dict[Tuple, Any]], name: str,
               key: Tuple) -> bool:
        """Under ``self._lock``: may ``(name, key)`` gain a series?
        Overflow counts on the drop counter directly (bypassing the
        guard — its own cardinality is bounded by the catalog)."""
        series = store.get(name)
        if series is None or key in series or \
                len(series) < self._series_cap or name == SERIES_DROPPED:
            return True
        dropped = self._counters.setdefault(SERIES_DROPPED, {})
        dkey = (('metric', name),)
        dropped[dkey] = dropped.get(dkey, 0.0) + 1.0
        return False

    def mark_reset_on_close(self, name: str) -> None:
        """Mark ``name`` as a *residency* gauge: it describes live
        occupancy (queue depth, in-flight chunks, breaker states), so
        after a drain/shutdown its series must export 0, not whatever
        the last sample happened to be.  Swept by
        :meth:`reset_residency_gauges` (cmd/internal.Setup.shutdown)."""
        with self._lock:
            self._reset_on_close.add(name)

    def reset_residency_gauges(self) -> None:
        """Zero every series of every gauge marked reset_on_close.
        Series are zeroed, not retracted — 'scraped the drained server
        and saw 0' is the signal; a vanished series reads as target
        loss."""
        with self._lock:
            for name in self._reset_on_close:
                series = self._gauges.get(name)
                if series is not None:
                    for key in series:
                        series[key] = 0.0

    def register_histogram(self, name: str,
                           buckets: Tuple[float, ...]) -> None:
        """Per-histogram bucket override; must run before the first
        ``observe`` of ``name`` (bucket counters are sized on first
        sample)."""
        with self._lock:
            if name not in self._hists:
                self._buckets[name] = tuple(buckets)

    def configure(self, disabled: List[str]) -> None:
        with self._lock:
            self._disabled = set(disabled)

    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        if name in self._disabled:
            return
        key = tuple(sorted(labels.items()))
        with self._lock:
            if not self._admit(self._counters, name, key):
                return
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + amount

    def set_gauge(self, name: str, value: float, **labels) -> None:
        # zero is a legitimate gauge value (a scraped series vanishing
        # reads as "target gone", not "value is 0") — intentional
        # removal goes through clear_gauge
        if name in self._disabled:
            return
        key = tuple(sorted(labels.items()))
        with self._lock:
            if not self._admit(self._gauges, name, key):
                return
            self._gauges.setdefault(name, {})[key] = value

    def clear_gauge(self, name: str, **labels) -> None:
        """Drop one gauge series from exposition (retraction of a
        no-longer-existing label combination, e.g. a deleted rule)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            series = self._gauges.get(name)
            if series is not None:
                series.pop(key, None)

    def gauge_value(self, name: str, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._gauges.get(name, {}).get(key, 0.0)

    def gauge_total(self, name: str) -> float:
        with self._lock:
            return sum(self._gauges.get(name, {}).values())

    def observe(self, name: str, value: float, **labels) -> None:
        if name in self._disabled:
            return
        key = tuple(sorted(labels.items()))
        with self._lock:
            if not self._admit(self._hists, name, key):
                return
            bounds = self._buckets.get(name, _DEFAULT_BUCKETS)
            series = self._hists.setdefault(name, {})
            entry = series.get(key)
            if entry is None:
                entry = [0, 0.0, [0] * len(bounds)]
                series[key] = entry
            entry[0] += 1
            entry[1] += value
            for i, bound in enumerate(bounds):
                if value <= bound:
                    entry[2][i] += 1

    def histogram_sum(self, name: str, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            entry = self._hists.get(name, {}).get(key)
            return entry[1] if entry is not None else 0.0

    def histogram_count(self, name: str, **labels) -> int:
        key = tuple(sorted(labels.items()))
        with self._lock:
            entry = self._hists.get(name, {}).get(key)
            return entry[0] if entry is not None else 0

    def histogram_series(self, name: str) -> List[Tuple[Tuple, int, float]]:
        """(label key, count, sum) per series — stage-breakdown reads."""
        with self._lock:
            return [(key, entry[0], entry[1])
                    for key, entry in self._hists.get(name, {}).items()]

    # -- reads -----------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._counters.get(name, {}).get(key, 0.0)

    def counter_total(self, name: str) -> float:
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def snapshot(self, identity: Optional[Dict[str, Any]] = None) -> Dict:
        """JSON-able point-in-time dump of every series, tagged with a
        process ``identity`` ({host, pid, process_index}) — the unit of
        cross-host federation (``observability/fleet.py``).  Label keys
        serialize as ``[[k, v], ...]`` pairs; histogram entries carry
        their bucket bounds so a merge can verify compatibility."""
        with self._lock:
            return {
                'identity': dict(identity or {}),
                'counters': {
                    name: [[list(map(list, key)), value]
                           for key, value in series.items()]
                    for name, series in self._counters.items()},
                'gauges': {
                    name: [[list(map(list, key)), value]
                           for key, value in series.items()]
                    for name, series in self._gauges.items()},
                'hists': {
                    name: {
                        'buckets': list(
                            self._buckets.get(name, _DEFAULT_BUCKETS)),
                        'series': [[list(map(list, key)), entry[0],
                                    entry[1], list(entry[2])]
                                   for key, entry in series.items()],
                    }
                    for name, series in self._hists.items()},
                'reset_on_close': sorted(self._reset_on_close),
            }

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._counters):
                _append_help(out, name)
                out.append(f'# TYPE {name} counter')
                for key, value in sorted(self._counters[name].items()):
                    out.append(f'{name}{_fmt_labels(key)} {_fmt(value)}')
            for name in sorted(self._gauges):
                _append_help(out, name)
                out.append(f'# TYPE {name} gauge')
                for key, value in sorted(self._gauges[name].items()):
                    out.append(f'{name}{_fmt_labels(key)} {_fmt(value)}')
            for name in sorted(self._hists):
                _append_help(out, name)
                out.append(f'# TYPE {name} histogram')
                bounds = self._buckets.get(name, _DEFAULT_BUCKETS)
                for key, (count, total, buckets) in sorted(
                        self._hists[name].items()):
                    # observe() already stores cumulative bucket counts
                    for bound, b in zip(bounds, buckets):
                        lk = key + (('le', _fmt(bound)),)
                        out.append(
                            f'{name}_bucket{_fmt_labels(lk)} {b}')
                    lk = key + (('le', '+Inf'),)
                    out.append(f'{name}_bucket{_fmt_labels(lk)} {count}')
                    out.append(f'{name}_sum{_fmt_labels(key)} '
                               f'{_fmt(total)}')
                    out.append(f'{name}_count{_fmt_labels(key)} {count}')
        return '\n'.join(out) + '\n'


def _append_help(out: List[str], name: str) -> None:
    """# HELP line from the metric catalog (every exported name is
    cataloged — enforced by scripts/check_metric_names.py)."""
    from .catalog import METRICS
    metric = METRICS.get(name)
    if metric is not None:
        out.append(f'# HELP {name} {metric.help}')


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(key: Tuple) -> str:
    if not key:
        return ''
    parts = ','.join(f'{k}="{v}"' for k, v in key)
    return '{' + parts + '}'


# -- process-global registry ------------------------------------------------
# The daemons create one registry in cmd/internal.Setup; subsystems that
# cannot take a registry parameter (device pipeline, webhook timing)
# publish through this hook.  None until configured: every emit site
# checks and no-ops, so an unconfigured process pays one attribute read.

_GLOBAL: Optional[MetricsRegistry] = None


def set_global_registry(registry: Optional[MetricsRegistry]) -> None:
    global _GLOBAL
    _GLOBAL = registry


def global_registry() -> Optional[MetricsRegistry]:
    return _GLOBAL


# instrument names (reference: pkg/metrics/metrics.go:91-224)
POLICY_RESULTS = 'kyverno_policy_results_total'
POLICY_EXECUTION_DURATION = 'kyverno_policy_execution_duration_seconds'
POLICY_CHANGES = 'kyverno_policy_changes_total'
ADMISSION_REVIEW_DURATION = 'kyverno_admission_review_duration_seconds'
ADMISSION_REQUESTS = 'kyverno_admission_requests_total'
CLIENT_QUERIES = 'kyverno_client_queries_total'


def record_policy_results(registry: MetricsRegistry, response,
                          operation: str = '') -> None:
    """reference: pkg/metrics/policyresults/metrics.go"""
    pr = response.policy_response
    for rule in pr.rules:
        registry.inc(
            POLICY_RESULTS,
            policy_name=pr.policy_name,
            rule_name=rule.name,
            rule_result=str(rule.status),
            rule_type=str(rule.rule_type),
            resource_kind=pr.resource_kind,
            resource_namespace=pr.resource_namespace,
            resource_request_operation=operation.lower())
    registry.observe(
        POLICY_EXECUTION_DURATION, pr.processing_time or 0.0,
        policy_name=pr.policy_name)
