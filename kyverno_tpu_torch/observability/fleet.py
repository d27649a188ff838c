"""Fleet observatory: mesh-step skew analysis + cross-host metric
federation.

The single-host observability stack (stage spans, coverage, SLO burn,
critical-path timelines) says nothing about the sharded mesh path —
``parallel/mesh.py`` dispatches over N devices and, before this module,
emitted no per-shard attribution at all.  Three pieces close that gap:

* **Mesh-step telemetry** — ``distributed_scan_step`` feeds every
  sharded dispatch through :func:`record_step`: per-shard device-eval
  walls (host-side readback-wait splits of this rank's shard, with
  the ``mesh_shard`` fault site timed inside each split so injected
  straggler delays attribute to exactly one shard), per-shard row
  occupancy, collective (all-reduce/all-gather) wall and padding waste.  The
  metric writes themselves live in ``parallel/mesh.py`` (ktpu-lint
  KTPU509 requires the shard/host identity labels at those sites).

* **Straggler blame** — :class:`SkewAnalyzer` keeps a sliding window
  (``KTPU_FLEET_SKEW_WINDOW``) of per-step skew ratios (max-shard /
  mean-shard) per mesh shape.  Sustained skew with a stable slowest
  shard names the device, renders a ``bound_by=straggler`` verdict
  through the critical-path advisor (``timeline.advise``) and fires
  the rate-limited deep profile (``profiling.deep_profile``, same
  single-fire/backoff contract as the SLO engine's auto-capture).

* **Cross-host federation** — :class:`FleetRegistry` snapshots each
  process's ``MetricsRegistry`` tagged ``{host, pid, process_index}``
  and merges snapshots: counters sum, histograms merge bucket-wise,
  gauges follow residency rules (occupancy gauges marked
  ``reset_on_close`` sum across the fleet; state gauges take the max).
  Snapshots arrive by pull (``GET /debug/fleet``), by JSONL files from
  a bench run (``scripts/fleet_report.py``), or programmatically
  (:meth:`FleetRegistry.add_snapshot` — keyed by identity, so re-adding
  a host's snapshot replaces it and the merge stays idempotent).

Contract: everything here is a no-op until :func:`configure` runs, and
``KTPU_FLEET=0`` keeps it off even then — the mesh path is
bit-identical to a build without this module (pinned by
``tests/test_distributed.py``).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import MetricsRegistry

_log = logging.getLogger(__name__)

# metric names written by the mesh path (the write sites live in
# parallel/mesh.py so KTPU509 can hold them to the fleet_scope labels)
MESH_STEP_DURATION = 'kyverno_tpu_mesh_step_duration_seconds'
MESH_SHARD_SKEW = 'kyverno_tpu_mesh_shard_skew_ratio'
MESH_COLLECTIVE_SECONDS = 'kyverno_tpu_mesh_collective_seconds_total'
MESH_PADDING_ROWS = 'kyverno_tpu_mesh_padding_rows_total'

#: windowed mean skew at or above this names a sustained straggler
SKEW_SUSTAINED_RATIO = 2.0
#: seconds between straggler-triggered deep profiles (same backoff
#: contract as observability/slo.py's burn-rate auto-capture)
PROFILE_MIN_INTERVAL_S = 60.0


def _skew_window() -> int:
    try:
        return max(2, int(os.environ.get('KTPU_FLEET_SKEW_WINDOW', '16')))
    except ValueError:
        return 16


def identity() -> Dict[str, Any]:
    """This process's federation identity: {host, pid, process_index}.
    ``process_index`` is the ``torch.distributed`` rank when a process
    group is initialized, else 0 — never initializes one."""
    process_index = 0
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            process_index = dist.get_rank()
    except Exception:  # noqa: BLE001 - identity must never fail
        process_index = 0
    return {'host': socket.gethostname(), 'pid': os.getpid(),
            'process_index': process_index}


def _identity_key(ident: Dict[str, Any]) -> Tuple:
    return (str(ident.get('host', '')), int(ident.get('pid', 0)),
            int(ident.get('process_index', 0)))


# -- straggler blame ---------------------------------------------------------


class SkewAnalyzer:
    """Sliding-window shard-skew analysis per mesh shape.

    One step's skew is ``max(shard_walls) / mean(shard_walls)`` — 1.0
    is perfectly balanced.  A window of steps with high mean skew AND a
    stable slowest shard is a *straggler*: the verdict names the shard
    and its device, carries ``bound_by=straggler`` for the critical-path
    advisor, and (once per :data:`PROFILE_MIN_INTERVAL_S`) captures a
    deep profile of the stalling process.
    """

    def __init__(self, window: Optional[int] = None,
                 now: Callable[[], float] = time.monotonic,
                 profile_trigger: Optional[Callable[[], Any]] = None):
        self.window = window or _skew_window()
        self.now = now
        self.profile_trigger = profile_trigger
        self._windows: Dict[str, deque] = {}
        self._sustained: Dict[str, bool] = {}
        self._last_profile = -PROFILE_MIN_INTERVAL_S
        self._lock = threading.Lock()
        self.auto_profiles = 0
        self.last_verdict: Optional[Dict[str, Any]] = None

    def fold(self, mesh_key: str, shard_walls: Sequence[float],
             devices: Sequence[str]) -> Dict[str, Any]:
        """Fold one step's per-shard walls in; returns the step verdict
        (skew ratio, slowest shard/device, sustained flag and — when
        sustained — the advisor's straggler note)."""
        walls = [max(0.0, float(w)) for w in shard_walls]
        mean = sum(walls) / len(walls) if walls else 0.0
        peak = max(walls) if walls else 0.0
        skew = (peak / mean) if mean > 0 else 1.0
        slow = walls.index(peak) if walls else 0
        fire = False
        with self._lock:
            win = self._windows.setdefault(
                mesh_key, deque(maxlen=self.window))
            win.append((skew, slow))
            full = len(win) >= self.window
            mean_skew = sum(s for s, _ in win) / len(win)
            slow_counts: Dict[int, int] = {}
            for _s, sh in win:
                slow_counts[sh] = slow_counts.get(sh, 0) + 1
            modal = max(slow_counts, key=lambda k: slow_counts[k])
            stable = slow_counts[modal] * 2 >= len(win)
            sustained = bool(full and stable and
                             mean_skew >= SKEW_SUSTAINED_RATIO)
            was = self._sustained.get(mesh_key, False)
            self._sustained[mesh_key] = sustained
            if sustained and not was:
                t = self.now()
                if t - self._last_profile >= PROFILE_MIN_INTERVAL_S:
                    self._last_profile = t
                    self.auto_profiles += 1
                    fire = True
        device = str(devices[slow]) if slow < len(devices) else str(slow)
        verdict: Dict[str, Any] = {
            'mesh': mesh_key,
            'skew': round(skew, 4),
            'window_mean_skew': round(mean_skew, 4),
            'slow_shard': slow,
            'device': device,
            'sustained': sustained,
        }
        if sustained:
            # the straggler verdict rides the same advisor surface the
            # pipeline critical path uses: the excess fraction is how
            # much of the slowest shard's wall is pure imbalance
            from . import timeline
            frac = 1.0 - (mean / peak) if peak > 0 else 0.0
            suggest, note = timeline.advise(
                'straggler', frac, detail=f'shard {slow} ({device})')
            verdict['bound_by'] = 'straggler'
            verdict['suggest'] = suggest
            verdict['note'] = note
        with self._lock:
            self.last_verdict = verdict
        if fire:
            self._capture(verdict)
        return verdict

    def _capture(self, verdict: Dict[str, Any]) -> None:
        trigger = self.profile_trigger
        if trigger is None:
            from . import profiling

            def trigger():
                return profiling.deep_profile(seconds=2.0,
                                              trigger='mesh_skew')
        _log.error(
            'sustained mesh skew (mean %.2fx over %d steps, straggler '
            '%s): capturing auto-profile', verdict['window_mean_skew'],
            self.window, verdict['device'])

        def work():
            try:
                trigger()
            except Exception:  # noqa: BLE001 - capture is best-effort
                _log.exception('mesh-skew auto-profile capture failed')

        threading.Thread(target=work, name='ktpu-fleet-profile',
                         daemon=True).start()

    def verdict(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self.last_verdict) if self.last_verdict else None


# -- federation --------------------------------------------------------------


def _series_map(entries: List) -> Dict[Tuple, float]:
    return {tuple(tuple(pair) for pair in key): value
            for key, value in entries}


def _series_list(series: Dict[Tuple, Any]) -> List:
    return [[list(map(list, key)), value]
            for key, value in sorted(series.items())]


class FleetRegistry:
    """Per-process metric snapshots keyed by identity + their merge.

    Merge rules (the federation's residency semantics):

    * **counters** — sum across processes (monotone totals compose);
    * **histograms** — counts, sums and bucket counts sum when bucket
      bounds agree; a bounds conflict keeps the larger-count series
      and flags ``bucket_conflict`` instead of fabricating quantiles;
    * **gauges** — occupancy gauges (``mark_reset_on_close`` residency
      set: queue depths, in-flight chunks, breaker states) sum — fleet
      occupancy is the sum of per-host occupancy; all other gauges
      take the max across processes (a ratio/state gauge averaged over
      hosts would describe no process at all).

    ``add_snapshot`` keys by ``{host, pid, process_index}``, so merging
    is idempotent (re-adding a host's snapshot replaces it) and
    associative (the merged doc of merged docs equals the flat merge).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry
        self._snapshots: Dict[Tuple, Dict] = {}
        self._lock = threading.Lock()

    def local_snapshot(self) -> Optional[Dict]:
        if self._registry is None:
            return None
        return self._registry.snapshot(identity())

    def add_snapshot(self, doc: Dict) -> None:
        """Fold one process's snapshot in (identity-keyed upsert)."""
        key = _identity_key(doc.get('identity') or {})
        with self._lock:
            self._snapshots[key] = doc

    def snapshots(self) -> List[Dict]:
        """Every known snapshot, the local registry's freshest first."""
        with self._lock:
            remote = [doc for _k, doc in sorted(self._snapshots.items())]
        local = self.local_snapshot()
        if local is not None:
            lkey = _identity_key(local['identity'])
            remote = [d for d in remote
                      if _identity_key(d.get('identity') or {}) != lkey]
            return [local] + remote
        return remote

    @staticmethod
    def merge(docs: Sequence[Dict]) -> Dict:
        """Merge snapshot docs (or previously merged docs) into one."""
        counters: Dict[str, Dict[Tuple, float]] = {}
        gauges: Dict[str, Dict[Tuple, float]] = {}
        gauge_rule: Dict[str, str] = {}
        hists: Dict[str, Dict] = {}
        identities: List[Dict] = []
        seen = set()
        for doc in docs:
            for ident in (doc.get('identities') or
                          [doc.get('identity') or {}]):
                key = _identity_key(ident)
                if key not in seen:
                    seen.add(key)
                    identities.append(dict(ident))
            residency = set(doc.get('reset_on_close') or [])
            for name, entries in (doc.get('counters') or {}).items():
                dst = counters.setdefault(name, {})
                for key, value in _series_map(entries).items():
                    dst[key] = dst.get(key, 0.0) + value
            for name, entries in (doc.get('gauges') or {}).items():
                rule = 'sum' if name in residency else \
                    gauge_rule.get(name, 'max')
                gauge_rule[name] = rule
                dst = gauges.setdefault(name, {})
                for key, value in _series_map(entries).items():
                    if rule == 'sum':
                        dst[key] = dst.get(key, 0.0) + value
                    else:
                        dst[key] = max(dst.get(key, value), value)
            for name, h in (doc.get('hists') or {}).items():
                bounds = list(h.get('buckets') or [])
                dst_h = hists.setdefault(
                    name, {'buckets': bounds, 'series': {},
                           'bucket_conflict': False})
                compatible = dst_h['buckets'] == bounds
                if not compatible:
                    dst_h['bucket_conflict'] = True
                for entry in h.get('series') or []:
                    key = tuple(tuple(pair) for pair in entry[0])
                    count, total = int(entry[1]), float(entry[2])
                    buckets = list(entry[3])
                    cur = dst_h['series'].get(key)
                    if cur is None:
                        dst_h['series'][key] = [count, total, buckets]
                    else:
                        cur[0] += count
                        cur[1] += total
                        if compatible and len(cur[2]) == len(buckets):
                            cur[2] = [a + b for a, b
                                      in zip(cur[2], buckets)]
                        elif count > cur[0] - count:
                            cur[2] = buckets
        out_resid = sorted(n for n, r in gauge_rule.items()
                           if r == 'sum')
        return {
            'identities': identities,
            'counters': {n: _series_list(s)
                         for n, s in sorted(counters.items())},
            'gauges': {n: _series_list(s)
                       for n, s in sorted(gauges.items())},
            'hists': {n: {'buckets': h['buckets'],
                          'bucket_conflict': h['bucket_conflict'],
                          # snapshot wire format ([key, count, sum,
                          # buckets]) so merged docs re-merge
                          'series': [[list(map(list, key)), v[0], v[1],
                                      list(v[2])]
                                     for key, v
                                     in sorted(h['series'].items())]}
                      for n, h in sorted(hists.items())},
            'reset_on_close': out_resid,
        }

    def merged(self) -> Dict:
        return self.merge(self.snapshots())

    @staticmethod
    def counter_totals(doc: Dict) -> Dict[str, float]:
        """name → summed value across every series of ``doc`` (a
        snapshot or a merged doc) — the lossless-round-trip check."""
        out: Dict[str, float] = {}
        for name, entries in (doc.get('counters') or {}).items():
            out[name] = sum(value for _key, value in entries)
        return out

    def report(self) -> Dict[str, Any]:
        """The ``GET /debug/fleet`` body."""
        snaps = self.snapshots()
        analyzer = _analyzer
        return {
            'enabled': True,
            'identity': identity(),
            'processes': [s.get('identity') or {} for s in snaps],
            'merged': self.merge(snaps),
            'skew': analyzer.verdict() if analyzer is not None else None,
        }

    def render_table(self) -> str:
        """Terminal view (``?format=table``): merged counters/gauges
        one row each, plus the process census and skew verdict."""
        report = self.report()
        merged = report['merged']
        lines = ['fleet: %d process(es)' % len(report['processes'])]
        for ident in report['processes']:
            lines.append('  %s pid=%s process_index=%s' % (
                ident.get('host', '?'), ident.get('pid', '?'),
                ident.get('process_index', '?')))
        skew = report.get('skew')
        if skew:
            lines.append('skew: %(mesh)s %(skew).2fx slow_shard='
                         '%(slow_shard)d sustained=%(sustained)s'
                         % {**skew, 'skew': float(skew['skew'])})
        lines.append('')
        lines.append('%-52s %14s' % ('merged counter', 'total'))
        for name, entries in merged['counters'].items():
            total = sum(v for _k, v in entries)
            lines.append('%-52s %14g' % (name, total))
        lines.append('%-52s %14s' % ('merged gauge', 'value'))
        for name, entries in merged['gauges'].items():
            total = sum(v for _k, v in entries)
            lines.append('%-52s %14g' % (name, total))
        return '\n'.join(lines) + '\n'


# -- snapshot files (offline bench merge) ------------------------------------


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None) -> Dict:
    """Append this process's snapshot as one JSONL line (the per-host
    artifact a bench run leaves behind for offline federation)."""
    reg = registry or (_fleet._registry if _fleet is not None else None)
    if reg is None:
        raise RuntimeError('fleet snapshot needs a configured registry')
    doc = reg.snapshot(identity())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'a') as f:
        f.write(json.dumps(doc, sort_keys=True) + '\n')
    return doc


def read_snapshot_files(paths: Sequence[str]) -> List[Dict]:
    """Parse per-host JSONL snapshot files into snapshot docs."""
    docs: List[Dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    docs.append(json.loads(line))
    return docs


# -- mesh-step hook (called from parallel/mesh.py) ---------------------------


def record_step(mesh_key: str, shard_walls: Sequence[float],
                devices: Sequence[str]) -> Dict[str, Any]:
    """Feed one mesh step's per-shard walls to the skew analyzer;
    returns the verdict for the caller's span attrs / gauge write."""
    analyzer = _analyzer
    if analyzer is None:
        return {'skew': 1.0, 'slow_shard': 0, 'sustained': False,
                'mesh': mesh_key, 'device': ''}
    return analyzer.fold(mesh_key, shard_walls, devices)


# -- module state ------------------------------------------------------------


_fleet: Optional[FleetRegistry] = None
_analyzer: Optional[SkewAnalyzer] = None


def configure(registry: Optional[MetricsRegistry] = None,
              window: Optional[int] = None,
              now: Callable[[], float] = time.monotonic,
              profile_trigger: Optional[Callable[[], Any]] = None
              ) -> Optional[FleetRegistry]:
    """Arm the fleet observatory.  ``KTPU_FLEET=0`` keeps it off (the
    mesh path stays bit-identical to a build without this module);
    returns the installed :class:`FleetRegistry` or None."""
    global _fleet, _analyzer
    if os.environ.get('KTPU_FLEET', '1') == '0':
        _fleet = None
        _analyzer = None
        return None
    _fleet = FleetRegistry(registry)
    _analyzer = SkewAnalyzer(window=window, now=now,
                             profile_trigger=profile_trigger)
    return _fleet


def disable() -> None:
    global _fleet, _analyzer
    _fleet = None
    _analyzer = None


def enabled() -> bool:
    """Hot-path gate: one module-global read (devtel contract)."""
    return _fleet is not None


def fleet() -> Optional[FleetRegistry]:
    return _fleet


def analyzer() -> Optional[SkewAnalyzer]:
    return _analyzer


def registry() -> Optional[MetricsRegistry]:
    return _fleet._registry if _fleet is not None else None
