"""Pipeline critical-path observatory: per-chunk stage timelines.

The streaming scan pipeline (``compiler/pipeline.py``) overlaps encode,
h2d, device_eval, d2h and report assembly across worker threads; the
coarse per-stage busy/wall ratios already exported cannot say which
stage actually bounds the end-to-end wall — a stage can be 90% busy and
still be entirely off the critical path.  This module records a bounded,
lock-light per-chunk event timeline (enqueue, exec, retry and
backpressure-block intervals with thread identity) and walks the chunk
DAG backwards from the last event to attribute every second of scan
wall to exactly one stage as exclusive "blame":

* a chunk×stage node is gated by its upstream stage on the same chunk
  and by the same stage on the previous chunk (one worker per stage,
  FIFO) — whichever ended last is the edge the critical path follows;
* the segment between the gate's end and the node's end is blamed on
  the node's stage, split into ``executing`` (the stage was running)
  and ``waiting`` (queued / blocked while on the path);
* the walk terminates at the scan origin, so blame seconds sum exactly
  to the scan wall — fractions are directly "what to speed up".

Everything is off until :func:`configure` runs, and ``KTPU_TIMELINE=0``
keeps it off entirely — the scan path is bit-identical to a build
without this module (the same contract as the flight recorder and the
admission SLO engine).  When on, the per-scan event budget is bounded
by ``KTPU_TIMELINE_N``; events past it are counted, never buffered.
"""

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import device as devtel

#: counter: exclusive critical-path seconds attributed per stage=
PIPELINE_BLAME = 'kyverno_tpu_pipeline_blame_seconds_total'

#: dataflow order of the chunk DAG — the blame walk only follows these
#: stages; auxiliary labels ('intake' feeder accounting, watchdog
#: spans) still land in the trace but never on the critical path.
STAGE_ORDER = ('pack', 'encode', 'h2d', 'compile', 'device_eval',
               'd2h', 'report')

_ORDER_IDX = {s: i for i, s in enumerate(STAGE_ORDER)}

EVENT_KINDS = ('exec', 'queue', 'retry', 'block')


class StageEvent:
    """One closed interval on a chunk's lifeline.

    ``kind`` is one of ``exec`` (the stage ran), ``queue`` (sitting in
    the inter-stage queue), ``retry`` (backoff sleep before re-running
    the stage) or ``block`` (producer blocked pushing downstream /
    feeder blocked on the depth semaphore).
    """

    __slots__ = ('chunk', 'stage', 'kind', 't0', 't1', 'thread',
                 'attempt')

    def __init__(self, chunk, stage, kind, t0, t1, thread='', attempt=0):
        self.chunk = chunk
        self.stage = stage
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.thread = thread
        self.attempt = attempt


class ScanTimeline:
    """Event log for one scan: append-only, bounded, lock-light.

    Pipeline worker threads touch disjoint ``(chunk, stage)`` keys and
    CPython list-append / dict set-pop are atomic, so the hot-path
    methods take no lock; only finalization (single-threaded, after the
    workers joined) aggregates.
    """

    __slots__ = ('scan_id', 't0', 't_end', 'max_events', 'events',
                 'dropped', '_open', '_pending', 'summary')

    def __init__(self, scan_id: int, max_events: int):
        self.scan_id = scan_id
        self.t0 = time.monotonic()
        self.t_end: Optional[float] = None
        self.max_events = max_events
        self.events: List[StageEvent] = []
        self.dropped = 0
        self._open: Dict[Tuple[int, str], Tuple[float, str]] = {}
        self._pending: Dict[Tuple[int, str], float] = {}
        self.summary: Optional[Dict[str, Any]] = None

    # -- hot path ---------------------------------------------------------

    def _add(self, ev: StageEvent) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def enqueue(self, chunk: int, stage: str) -> None:
        """Mark the chunk as handed to ``stage``'s input queue."""
        self._pending[(chunk, stage)] = time.monotonic()

    def start(self, chunk: int, stage: str) -> None:
        """The stage's worker picked the chunk up and began executing."""
        now = time.monotonic()
        key = (chunk, stage)
        t_q = self._pending.pop(key, None)
        if t_q is not None and now > t_q:
            self._add(StageEvent(chunk, stage, 'queue', t_q, now,
                                 threading.current_thread().name))
        self._open[key] = (now, threading.current_thread().name)

    def end(self, chunk: int, stage: str, ok: bool = True) -> None:
        """The stage finished (or errored out) on this chunk."""
        now = time.monotonic()
        entry = self._open.pop((chunk, stage), None)
        if entry is None:
            return
        t_start, thread = entry
        self._add(StageEvent(chunk, stage, 'exec', t_start, now, thread,
                             attempt=0 if ok else -1))

    def record(self, stage: str, chunk: int, t0: float,
               t1: Optional[float] = None, kind: str = 'exec',
               thread: Optional[str] = None, attempt: int = 0) -> None:
        """Record an already-measured interval (inline paths, forked
        encode workers shipping their timing home, report windows)."""
        self._add(StageEvent(
            chunk, stage, kind, t0,
            time.monotonic() if t1 is None else t1,
            threading.current_thread().name if thread is None else thread,
            attempt))

    def retry(self, chunk: int, stage: str, t0: float,
              attempt: int) -> None:
        self.record(stage, chunk, t0, kind='retry', attempt=attempt)

    def block(self, chunk: int, stage: str, t0: float) -> None:
        self.record(stage, chunk, t0, kind='block')

    # -- finalization -----------------------------------------------------

    def open_count(self) -> int:
        """Exec intervals started but never ended (must be 0 after a
        pipeline drain, including early generator close)."""
        return len(self._open)

    def close_open(self) -> None:
        """Close any still-open exec intervals (pipeline teardown path:
        a stage aborted mid-chunk on early generator close)."""
        now = time.monotonic()
        for key in list(self._open):
            entry = self._open.pop(key, None)
            if entry is None:
                continue
            t_start, thread = entry
            self._add(StageEvent(key[0], key[1], 'exec', t_start, now,
                                 thread, attempt=-1))
        self._pending.clear()

    def finalize(self) -> Dict[str, Any]:
        if self.summary is not None:
            return self.summary
        self.close_open()
        self.t_end = time.monotonic()
        self.summary = analyze(self.events, self.t0, self.t_end)
        self.summary['scan_id'] = self.scan_id
        self.summary['events'] = len(self.events)
        self.summary['dropped'] = self.dropped
        return self.summary


# -- critical-path analysis ---------------------------------------------------


def analyze(events: Iterable[StageEvent], t0: float,
            t_end: float) -> Dict[str, Any]:
    """Walk the chunk DAG backwards and attribute wall time to stages.

    Merges exec events per (chunk, stage) node, then from the
    latest-ending node repeatedly blames the segment back to its gating
    predecessor's end — the predecessor being whichever of (same chunk,
    nearest upstream stage) / (previous chunk, same stage) ended last.
    The walk bottoms out at the scan origin and a trailing consumer
    segment is charged to report, so blame sums exactly to the wall.
    """
    wall = max(0.0, t_end - t0)
    execs: Dict[Tuple[int, str], List[float]] = {}
    for ev in events:
        if ev.kind != 'exec' or ev.stage not in _ORDER_IDX:
            continue
        key = (ev.chunk, ev.stage)
        cur = execs.get(key)
        if cur is None:
            execs[key] = [ev.t0, ev.t1, ev.t1 - ev.t0]
        else:
            cur[0] = min(cur[0], ev.t0)
            cur[1] = max(cur[1], ev.t1)
            cur[2] += ev.t1 - ev.t0

    blame: Dict[str, float] = {}
    executing: Dict[str, float] = {}
    waiting: Dict[str, float] = {}

    def charge(stage, seg, ex):
        blame[stage] = blame.get(stage, 0.0) + seg
        executing[stage] = executing.get(stage, 0.0) + ex
        waiting[stage] = waiting.get(stage, 0.0) + (seg - ex)

    if execs:
        def preds(key):
            c, s = key
            out = []
            for ps in reversed(STAGE_ORDER[:_ORDER_IDX[s]]):
                if (c, ps) in execs:
                    out.append((c, ps))
                    break
            if (c - 1, s) in execs:
                out.append((c - 1, s))
            return out

        cur = max(execs, key=lambda k: execs[k][1])
        last_end = execs[cur][1]
        # trailing segment after the last pipeline event — the consumer
        # drained rows / assembled the tail of the report
        if t_end > last_end:
            charge('report', t_end - last_end, 0.0)
        t_hi = last_end
        # the walk strictly decreases (chunk + stage index); bound it
        for _ in range(len(execs) + len(STAGE_ORDER) + 2):
            if cur is None:
                break
            n0, n1, _busy = execs[cur]
            ps = preds(cur)
            gate = max(ps, key=lambda k: execs[k][1]) if ps else None
            lo = execs[gate][1] if gate is not None else t0
            lo = min(lo, t_hi)
            seg = t_hi - lo
            ex = max(0.0, min(t_hi, n1) - max(lo, n0))
            charge(cur[1], seg, min(ex, seg))
            t_hi = lo
            cur = gate
    else:
        charge('report', wall, 0.0)

    total = sum(blame.values())
    frac = {s: (v / total if total > 0 else 0.0)
            for s, v in blame.items()}
    bound_by = max(blame, key=lambda s: blame[s]) if blame else ''
    suggest, note = advise(bound_by, frac.get(bound_by, 0.0))
    blame_r = {s: round(v, 6) for s, v in blame.items()}
    executing_r = {s: round(v, 6) for s, v in executing.items()}
    # waiting derives from the rounded pair so the executing+waiting ==
    # blame partition survives rounding exactly
    waiting_r = {s: round(max(0.0, blame_r[s] - executing_r.get(s, 0.0)), 6)
                 for s in blame_r}
    return {
        'wall_s': round(wall, 6),
        'blame_s': blame_r,
        'blame_frac': {s: round(v, 4) for s, v in frac.items()},
        'executing_s': executing_r,
        'waiting_s': waiting_r,
        'bound_by': bound_by,
        'suggest': suggest,
        'note': note,
        'chunks': len({c for c, _s in execs}),
    }


def advise(bound_by: str, frac: float,
           detail: str = '') -> Tuple[Dict[str, str], str]:
    """Turn a blame verdict into concrete knob deltas.

    Returns ``(suggest, note)``: env-knob deltas worth trying plus a
    one-line rationale.  Deliberately coarse — the observatory names
    the wall to push on, the operator (or the bench sweep) confirms.
    ``detail`` carries verdict-specific context (the fleet skew
    analyzer passes the straggler's shard/device identity).
    """
    pct = f'{frac * 100:.0f}%'
    if bound_by == 'straggler':
        # fed by the fleet skew analyzer (observability/fleet.py):
        # one shard's device-eval wall dominates a sustained window of
        # mesh steps — no host-pipeline knob fixes a slow device
        who = detail or 'one shard'
        return ({},
                f'mesh straggler: {who} carries {pct} excess '
                f'device-eval wall over the skew window — rebalance '
                f'or drain that device/host; deepening the host '
                f'pipeline cannot help a slow shard')
    if bound_by == 'encode':
        return ({'KTPU_ENCODE_PROCS': '+2', 'KTPU_PIPELINE_DEPTH': '+1'},
                f'host encode holds {pct} of the critical path: add '
                f'forked encode workers and a pipeline slot so h2d '
                f'never starves')
    if bound_by in ('h2d', 'd2h'):
        return ({'KTPU_PIPELINE_DEPTH': '+1'},
                f'{bound_by} transfer holds {pct} of the critical '
                f'path: deepen the pipeline so transfers overlap more '
                f'compute')
    if bound_by in ('device_eval', 'compile', 'pack'):
        return ({},
                f'{bound_by} holds {pct} of the critical path: the '
                f'host pipeline keeps the device fed — speedups must '
                f'come from the kernel/compile side, not more overlap')
    if bound_by == 'report':
        return ({'KTPU_REPORT_FLUSH_ROWS': 'x2'},
                f'report assembly holds {pct} of the critical path: '
                f'widen the flush window or thin the per-row work')
    return ({}, '')


def format_summary(summary: Optional[Dict[str, Any]]) -> str:
    """Compact single-attr rendering for spans:
    ``bound_by=<s> <stage>=<frac> ...`` in descending blame order."""
    if not summary:
        return ''
    frac = summary.get('blame_frac') or {}
    parts = ['bound_by=%s' % summary.get('bound_by', '')]
    for s, f in sorted(frac.items(), key=lambda kv: -kv[1]):
        parts.append('%s=%.2f' % (s, f))
    return ' '.join(parts)


# -- recorder -----------------------------------------------------------------


class TimelineRecorder:
    """Process-wide home for finished scan timelines.

    Keeps the last ``max_scans`` timelines for trace export, cumulative
    per-stage blame totals for the metric/bench deltas, and the most
    recent summary for the debug endpoint.
    """

    def __init__(self, max_events: int, max_scans: int = 16):
        self.max_events = max_events
        self._seq = itertools.count(1)
        self._scans: "deque[ScanTimeline]" = deque(maxlen=max_scans)
        self._lock = threading.Lock()
        self._blame_totals: Dict[str, float] = {}
        self._wall_total = 0.0
        self.n_scans = 0
        self.last_summary: Optional[Dict[str, Any]] = None

    def begin(self) -> ScanTimeline:
        return ScanTimeline(next(self._seq), self.max_events)

    def finish(self, tl: ScanTimeline) -> Dict[str, Any]:
        summary = tl.finalize()
        with self._lock:
            for s, v in summary['blame_s'].items():
                self._blame_totals[s] = self._blame_totals.get(s, 0.0) + v
            self._wall_total += summary['wall_s']
            self.n_scans += 1
            self.last_summary = summary
            self._scans.append(tl)
        reg = devtel.registry()
        if reg is not None:
            for s, v in summary['blame_s'].items():
                if v > 0:
                    reg.inc(PIPELINE_BLAME, v, stage=s)
        cap = devtel.current_capture()
        if cap is not None:
            cap.critical_path = summary
        return summary

    def blame_totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._blame_totals)

    def wall_total(self) -> float:
        with self._lock:
            return self._wall_total

    def scans(self) -> List[ScanTimeline]:
        with self._lock:
            return list(self._scans)

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.scans())


# -- module state -------------------------------------------------------------

_recorder: Optional[TimelineRecorder] = None
_tl_var: "contextvars.ContextVar[Optional[ScanTimeline]]" = \
    contextvars.ContextVar('ktpu_timeline', default=None)


def configure(max_events: Optional[int] = None,
              max_scans: int = 16) -> Optional[TimelineRecorder]:
    """Arm the recorder.  ``KTPU_TIMELINE=0`` wins: stays off, returns
    None, and every scan-path hook stays on its zero-cost branch."""
    global _recorder
    if os.environ.get('KTPU_TIMELINE', '1') == '0':
        _recorder = None
        return None
    if max_events is None:
        try:
            max_events = int(os.environ.get('KTPU_TIMELINE_N', '4096'))
        except ValueError:
            max_events = 4096
    _recorder = TimelineRecorder(max(max_events, 16), max_scans)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def recorder() -> Optional[TimelineRecorder]:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def begin_scan() -> Optional[ScanTimeline]:
    rec = _recorder
    return rec.begin() if rec is not None else None


def finish_scan(tl: Optional[ScanTimeline]) -> Optional[Dict[str, Any]]:
    if tl is None:
        return None
    rec = _recorder
    if rec is None:
        return tl.finalize()
    return rec.finish(tl)


def blame_totals() -> Dict[str, float]:
    rec = _recorder
    return rec.blame_totals() if rec is not None else {}


def last_critical_path() -> Optional[Dict[str, Any]]:
    rec = _recorder
    return rec.last_summary if rec is not None else None


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class _ExecScope:
    __slots__ = ('_tl', '_chunk', '_stage')

    def __init__(self, tl, chunk, stage):
        self._tl = tl
        self._chunk = chunk
        self._stage = stage

    def __enter__(self):
        self._tl.start(self._chunk, self._stage)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tl.end(self._chunk, self._stage, ok=exc_type is None)
        return False


def exec_scope(tl: Optional[ScanTimeline], chunk: int, stage: str):
    """Context manager recording an exec interval; free no-op when the
    timeline is off (the inline single-chunk path wraps stages in it
    unconditionally)."""
    if tl is None:
        return _NOOP_SCOPE
    return _ExecScope(tl, chunk, stage)


# -- Chrome-trace / Perfetto export -------------------------------------------


def chrome_trace(timelines: List[ScanTimeline]) -> Dict[str, Any]:
    """Render timelines as Chrome trace-event JSON (Perfetto loads it
    directly): one pid per scan, one tid per worker thread, complete
    'X' events per interval plus 'M' name metadata."""
    out: List[Dict[str, Any]] = []
    if not timelines:
        return {'traceEvents': out, 'displayTimeUnit': 'ms'}
    base = min(tl.t0 for tl in timelines)
    for tl in timelines:
        pid = tl.scan_id
        tids: Dict[str, int] = {}
        out.append({'name': 'process_name', 'ph': 'M', 'pid': pid,
                    'tid': 0, 'args': {'name': 'scan-%d' % pid}})
        for ev in tl.events:
            tid = tids.get(ev.thread)
            if tid is None:
                tid = tids[ev.thread] = len(tids) + 1
                out.append({'name': 'thread_name', 'ph': 'M', 'pid': pid,
                            'tid': tid, 'args': {'name': ev.thread}})
            args: Dict[str, Any] = {'chunk': ev.chunk, 'kind': ev.kind}
            if ev.attempt:
                args['attempt'] = ev.attempt
            out.append({
                'name': ev.stage if ev.kind == 'exec'
                else '%s:%s' % (ev.stage, ev.kind),
                'cat': ev.kind,
                'ph': 'X',
                'ts': round((ev.t0 - base) * 1e6, 3),
                'dur': round(max(0.0, ev.t1 - ev.t0) * 1e6, 3),
                'pid': pid,
                'tid': tid,
                'args': args,
            })
    return {'traceEvents': out, 'displayTimeUnit': 'ms'}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Check a Chrome-trace document against the trace-event schema
    subset we emit/accept: a traceEvents list whose entries are 'M'
    metadata, complete 'X' events (numeric ts ≥ 0 and dur ≥ 0), or
    matched 'B'/'E' pairs with per-(pid,tid) monotonic timestamps.
    Returns a list of human-readable violations (empty == valid)."""
    errors: List[str] = []
    events = trace.get('traceEvents') if isinstance(trace, dict) else trace
    if not isinstance(events, list):
        return ['traceEvents: missing or not a list']
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    last_ts: Dict[Tuple[Any, Any], float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append('event %d: not an object' % i)
            continue
        ph = ev.get('ph')
        if ph == 'M':
            continue
        if ph not in ('X', 'B', 'E'):
            errors.append('event %d: unsupported ph=%r' % (i, ph))
            continue
        ts = ev.get('ts')
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append('event %d: bad ts=%r' % (i, ts))
            continue
        key = (ev.get('pid'), ev.get('tid'))
        if ph == 'X':
            dur = ev.get('dur')
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append('event %d: X event bad dur=%r' % (i, dur))
        else:
            if ts < last_ts.get(key, float('-inf')):
                errors.append(
                    'event %d: ts %r not monotonic on pid/tid %r'
                    % (i, ts, key))
            last_ts[key] = ts
            stack = stacks.setdefault(key, [])
            if ph == 'B':
                stack.append(ev.get('name', ''))
            else:
                if not stack:
                    errors.append(
                        'event %d: E without matching B on pid/tid %r'
                        % (i, key))
                else:
                    stack.pop()
    for key, stack in stacks.items():
        for name in stack:
            errors.append('unclosed B event %r on pid/tid %r'
                          % (name, key))
    return errors


def blame_from_chrome(trace: Any) -> Dict[str, Any]:
    """Reconstruct per-scan blame from an exported trace file (the
    offline path for ``scripts/timeline_report.py``): groups exec 'X'
    events by pid, reruns the analyzer per scan, and sums."""
    events = trace.get('traceEvents') if isinstance(trace, dict) else trace
    per_pid: Dict[Any, List[StageEvent]] = {}
    for ev in events or []:
        if not isinstance(ev, dict) or ev.get('ph') != 'X':
            continue
        args = ev.get('args') or {}
        kind = args.get('kind', ev.get('cat', 'exec'))
        t0 = float(ev.get('ts', 0)) / 1e6
        t1 = t0 + float(ev.get('dur', 0)) / 1e6
        name = ev.get('name', '')
        stage = name.split(':', 1)[0]
        per_pid.setdefault(ev.get('pid'), []).append(StageEvent(
            args.get('chunk', -1), stage, kind, t0, t1,
            str(ev.get('tid', '')), args.get('attempt', 0)))
    scans = []
    totals: Dict[str, float] = {}
    wall = 0.0
    for pid in sorted(per_pid, key=lambda p: (str(type(p)), str(p))):
        evs = per_pid[pid]
        lo = min(e.t0 for e in evs)
        hi = max(e.t1 for e in evs)
        summary = analyze(evs, lo, hi)
        summary['scan_id'] = pid
        scans.append(summary)
        wall += summary['wall_s']
        for s, v in summary['blame_s'].items():
            totals[s] = totals.get(s, 0.0) + v
    total = sum(totals.values())
    frac = {s: (v / total if total > 0 else 0.0) for s, v in totals.items()}
    bound_by = max(totals, key=lambda s: totals[s]) if totals else ''
    suggest, note = advise(bound_by, frac.get(bound_by, 0.0))
    return {
        'scans': scans,
        'blame_s': {s: round(v, 6) for s, v in totals.items()},
        'blame_frac': {s: round(v, 4) for s, v in frac.items()},
        'wall_s': round(wall, 6),
        'bound_by': bound_by,
        'suggest': suggest,
        'note': note,
    }


def dump_chrome_trace(path: str) -> Optional[str]:
    """Write the recorder's current trace to ``path`` (creating parent
    dirs); returns the path, or None when the recorder is off."""
    rec = _recorder
    if rec is None:
        return None
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(rec.chrome_trace(), fh)
    return path
