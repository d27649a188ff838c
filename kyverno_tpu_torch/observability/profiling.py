"""Profiling endpoint (reference: pkg/profiling/pprof.go; flags
-profile / -profilePort=6060 at cmd/internal/flag.go:40-42).

Python equivalent of Go's net/http/pprof surface, plus the repo's own
debug routes.  Every route **self-registers** through
:func:`debug_route` into one table that drives four consumers — the
HTTP dispatch, the ``GET /debug/`` index, the 404-with-index response
for unknown ``/debug/*`` paths, and the README endpoint table
(``python scripts/analyze.py --debug-table``, drift-checked by
``tests/test_profiling_endpoints.py``) — so there is no hand-maintained
route list anywhere.

:func:`deep_profile` captures an on-demand deep profile: the Python
sampling profiler (folded stacks) plus a ``torch.profiler`` trace when
CUDA is already initialized, written under a bounded artifact
directory (``KTPU_PROFILE_DIR``, last :data:`PROFILE_KEEP` captures
kept).  Served at ``GET /debug/profile?seconds=N`` and auto-fired by
the SLO engine when burn rate degrades (``observability/slo.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import sys
import threading
import time
import traceback
from collections import Counter, OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import parse_qs, urlparse

#: auto-captures beyond this count evict the oldest artifact directory
PROFILE_KEEP = 8

_profile_seq = itertools.count(1)
_profile_lock = threading.Lock()


def thread_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f'thread {tid} ({names.get(tid, "?")}):')
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append('')
    return '\n'.join(out)


def sample_profile(seconds: float, hz: int = 100) -> str:
    """Folded-stacks sampling profile across all threads."""
    counts: Counter = Counter()
    deadline = time.time() + seconds
    interval = 1.0 / hz
    me = threading.get_ident()
    while time.time() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            frames = []
            f = frame
            while f is not None:
                code = f.f_code
                frames.append(f'{code.co_name} '
                              f'({code.co_filename.rsplit("/", 1)[-1]}:'
                              f'{f.f_lineno})')
                f = f.f_back
            counts[';'.join(reversed(frames))] += 1
        time.sleep(interval)
    return '\n'.join(f'{stack} {n}'
                     for stack, n in counts.most_common()) or '(idle)\n'


# -- deep profile capture ----------------------------------------------------

def _env_profile_dir() -> str:
    return os.environ.get(
        'KTPU_PROFILE_DIR',
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), '.cache', 'profiles'))


def _cuda_live() -> bool:
    """True only when torch is imported AND CUDA is already initialized
    in this process — deep_profile must never be the thing that pays (or
    hangs on) device bring-up."""
    if 'torch' not in sys.modules:
        return False
    try:
        import torch
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 - no CUDA build: skip trace
        return False


def _prune_profiles(root: str) -> None:
    """Keep the newest PROFILE_KEEP capture dirs (bounded artifacts —
    a burn-rate flap cannot fill the disk)."""
    try:
        entries = [e for e in os.scandir(root)
                   if e.is_dir() and e.name.startswith('profile-')]
    except OSError:
        return
    entries.sort(key=lambda e: e.stat().st_mtime)
    for entry in entries[:-PROFILE_KEEP]:
        shutil.rmtree(entry.path, ignore_errors=True)


def deep_profile(seconds: float = 2.0, trigger: str = 'manual',
                 out_dir: Optional[str] = None) -> dict:
    """Capture a deep profile: ``py.folded`` (sampling profiler, all
    threads) always; a ``torch/trace.json`` profiler trace (Chrome
    trace-event JSON of the card's kernels and this process's ops)
    when CUDA is live.  Artifacts land under
    ``<KTPU_PROFILE_DIR>/profile-<trigger>-<pid>-<n>/``; the directory
    is bounded to :data:`PROFILE_KEEP` captures.  Serialized per process (one capture at a time) — callers
    block for ``seconds``."""
    seconds = min(max(seconds, 0.01), 60.0)
    root = out_dir or _env_profile_dir()
    path = os.path.join(
        root, f'profile-{trigger}-{os.getpid()}-{next(_profile_seq)}')
    with _profile_lock:
        os.makedirs(path, exist_ok=True)
        artifacts: List[str] = []
        torch_traced = False
        prof = None
        gap: Dict[str, Any] = {}
        if _cuda_live():
            try:
                from torch.profiler import ProfilerActivity, profile
                from ..ops import kernels
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                before = dict(kernels.LAUNCHES)
                prof.start()
                torch_traced = True
            except Exception:  # noqa: BLE001 - py profile still lands
                torch_traced = False
        folded = sample_profile(seconds)
        if torch_traced:
            try:
                prof.stop()
                gap = {k: v for k, v in kernel_event_counts(
                    prof.key_averages(), before,
                    dict(kernels.LAUNCHES)).items()
                    if v['launches'] > v['profiler_events']}
                os.makedirs(os.path.join(path, 'torch'), exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(path, 'torch', 'trace.json'))
                artifacts.append('torch')
            except Exception:  # noqa: BLE001
                torch_traced = False
        with open(os.path.join(path, 'py.folded'), 'w') as f:
            f.write(folded)
        artifacts.append('py.folded')
        _prune_profiles(root)
    out = {'dir': path, 'seconds': seconds, 'trigger': trigger,
           'torch_trace': torch_traced, 'artifacts': artifacts}
    if gap:
        out['kernel_events'] = gap
        out['note'] = ('device time may be under-counted: the profiler '
                       'recorded fewer kernel events than the kernel '
                       'wrappers counted launches')
    return out


def kernel_event_counts(events, before: Dict[str, int],
                        after: Dict[str, int]) -> Dict[str, Any]:
    """Per hand-written kernel that launched or was seen: the launches
    its wrapper counted (``after - before``, ``ops/kernels.py
    LAUNCHES``) and the device events ``events`` (a profiler's
    ``key_averages()``) hold under the kernel's symbol,
    ``{kernel: {'launches': n, 'profiler_events': m}}``."""
    from torch.autograd import DeviceType
    from ..ops.kernels import KERNEL_SYMBOLS
    seen = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for evt in events:
        if evt.device_type != DeviceType.CUDA:
            continue
        for name, symbol in KERNEL_SYMBOLS.items():
            if symbol in evt.key:
                seen[name] += evt.count
    return {name: {'launches': after.get(name, 0) - before.get(name, 0),
                   'profiler_events': seen[name]}
            for name in KERNEL_SYMBOLS
            if after.get(name, 0) - before.get(name, 0) or seen[name]}


# -- debug route registry ----------------------------------------------------

class _Route(NamedTuple):
    path: str
    help: str
    fn: Callable[[Dict[str, List[str]]], Tuple[str, str, int]]


#: path → route, in registration order; the single source the HTTP
#: dispatch, /debug/ index, and README table all read
_ROUTES: 'OrderedDict[str, _Route]' = OrderedDict()


def debug_route(path: str, help: str):  # noqa: A002 - table DSL
    """Register ``fn(query) -> (body, content_type, status)`` as the
    handler for ``path`` on the profiling server."""
    def deco(fn):
        _ROUTES[path] = _Route(path, help, fn)
        return fn
    return deco


def routes() -> Dict[str, Tuple[str, str]]:
    """path → (help,) view for the index endpoint and tests."""
    return {r.path: (r.help,) for r in _ROUTES.values()}


def render_debug_index() -> str:
    """The ``GET /debug/`` body: every registered route, one line of
    help each (also the 404 body for unknown ``/debug/*`` paths)."""
    width = max(len(p) for p in _ROUTES) + 2
    lines = ['debug endpoints:', '']
    for path in sorted(_ROUTES):
        lines.append(f'  {path:<{width}}{_ROUTES[path].help}')
    return '\n'.join(lines) + '\n'


def render_debug_table() -> str:
    """The README endpoint table, generated so docs cannot drift from
    the registry (same contract as the knob table)."""
    rows = ['| Endpoint | Returns |', '|---|---|']
    for path in sorted(_ROUTES):
        rows.append(f'| `{path}` | {_ROUTES[path].help} |')
    return '\n'.join(rows)


def _bad_param(name: str) -> Tuple[str, str, int]:
    return f'bad {name} parameter', 'text/plain', 400


def _json_body(obj) -> Tuple[str, str, int]:
    return json.dumps(obj), 'application/json', 200


# -- routes ------------------------------------------------------------------

@debug_route('/debug/pprof', 'pprof profile index.')
def _r_pprof(query):
    return ('profiles:\n  goroutine\n  profile\n'
            '  traces\n  decisions\n  coverage\n', 'text/plain', 200)


@debug_route('/debug/pprof/goroutine',
             'All live thread stacks (goroutine profile analogue), '
             'plain text.')
def _r_goroutine(query):
    return thread_stacks(), 'text/plain', 200


@debug_route('/debug/pprof/profile',
             'Sampling CPU profile as folded stacks '
             '(`?seconds=N`, clamped to 60s).')
def _r_profile(query):
    try:
        seconds = float(query.get('seconds', ['1'])[0])
    except ValueError:
        return _bad_param('seconds')
    return (sample_profile(min(max(seconds, 0.01), 60.0)),
            'text/plain', 200)


@debug_route('/debug/traces',
             'Recent spans from the in-memory trace exporter as '
             'OTLP-shaped JSON (`?limit=N`, `?trace_id=...`).')
def _r_traces(query):
    from . import tracing
    mem = tracing.memory_exporter()
    spans = mem.spans() if mem is not None else []
    # ?trace_id= narrows to one trace, ?limit=N bounds the response to
    # the most recent N — flight-recorder follow-ups fetch one
    # decision's spans instead of paging the whole ring
    trace_id = query.get('trace_id', [''])[0]
    if trace_id:
        spans = [s for s in spans if s.trace_id == trace_id]
    try:
        limit = int(query.get('limit', ['0'])[0])
    except ValueError:
        return _bad_param('limit')
    if limit > 0:
        spans = spans[-limit:]
    return _json_body({'spans': [s.to_otlp() for s in spans]})


@debug_route('/debug/decisions',
             'Decision-provenance flight recorder: last N '
             'DecisionRecords + the error/shed ring (`?limit=N`).')
def _r_decisions(query):
    from . import provenance
    rec = provenance.recorder()
    if rec is None:
        return _json_body({'enabled': False})
    try:
        limit = int(query.get('limit', ['0'])[0]) or None
    except ValueError:
        return _bad_param('limit')
    return _json_body({
        'enabled': True,
        'stats': rec.stats(),
        'decisions': [r.to_dict() for r in rec.records(limit)],
        'errors': [r.to_dict() for r in rec.errors(limit)],
    })


@debug_route('/debug/coverage',
             'Device-coverage ledger: per-rule placement + attributed '
             'host-fallback counts, JSON.')
def _r_coverage(query):
    from . import coverage
    led = coverage.ledger()
    body = dict(led.report(), enabled=True) \
        if led is not None else {'enabled': False}
    return _json_body(body)


@debug_route('/debug/breakers',
             'Live circuit-breaker state per policy set (state '
             'machine position, failure/trip counts), JSON.')
def _r_breakers(query):
    from ..serving import breaker as breaker_mod
    return _json_body(breaker_mod.debug_report())


@debug_route('/debug/executables',
             'Executable lifecycle ledger: every compiled program '
             'with source, build cost, dispatch/device-time totals '
             '(JSON; `?format=table` for a terminal view).')
def _r_executables(query):
    from . import executables
    led = executables.ledger()
    if led is None:
        return _json_body({'enabled': False})
    if query.get('format', [''])[0] == 'table':
        return led.render_table(), 'text/plain', 200
    return _json_body(led.report())


@debug_route('/debug/partitions',
             'Partitioned-compilation census: per-partition member/'
             'fingerprint/executable attribution for each live plan '
             'plus the recent hot-swap log, JSON.')
def _r_partitions(query):
    from ..partition import census
    return _json_body(census.report())


@debug_route('/debug/slo',
             'Serving SLO state: burn rates, budget remaining, '
             'per-path windowed latency digests, JSON.')
def _r_slo(query):
    from . import slo
    eng = slo.engine()
    if eng is None:
        return _json_body({'enabled': False})
    return _json_body(dict(eng.snapshot(), enabled=True))


@debug_route('/debug/fleet',
             'Fleet observatory: merged cross-host metric federation, '
             'per-process snapshots and the mesh skew verdict (JSON; '
             '`?format=table` for a terminal view).')
def _r_fleet(query):
    from . import fleet
    fr = fleet.fleet()
    if fr is None:
        return _json_body({'enabled': False})
    if query.get('format', [''])[0] == 'table':
        return fr.render_table(), 'text/plain', 200
    return _json_body(fr.report())


@debug_route('/debug/profile',
             'On-demand deep profile (`?seconds=N`, clamped to 60s): '
             'py sampling profile + torch.profiler trace when CUDA is '
             'live; '
             'artifacts under KTPU_PROFILE_DIR, JSON summary.')
def _r_deep_profile(query):
    try:
        seconds = float(query.get('seconds', ['2'])[0])
    except ValueError:
        return _bad_param('seconds')
    return _json_body(deep_profile(seconds=seconds, trigger='manual'))


@debug_route('/debug/timeline',
             'Pipeline critical-path observatory: per-scan blame '
             'summaries + cumulative stage blame (JSON; '
             '`?format=chrome` exports the recent-scan timelines as '
             'Chrome trace-event JSON — load it in Perfetto).')
def _r_timeline(query):
    from . import timeline
    rec = timeline.recorder()
    if rec is None:
        return _json_body({'enabled': False})
    if query.get('format', [''])[0] == 'chrome':
        return _json_body(rec.chrome_trace())
    return _json_body({
        'enabled': True,
        'scans': rec.n_scans,
        'last': rec.last_summary,
        'blame_totals_s': {s: round(v, 6)
                           for s, v in rec.blame_totals().items()},
        'wall_total_s': round(rec.wall_total(), 6),
        'summaries': [tl.summary for tl in rec.scans()
                      if tl.summary is not None],
    })


@debug_route('/metrics',
             'Prometheus text exposition of the active registry.')
def _r_metrics(query):
    from . import device
    from .metrics import global_registry
    reg = device.registry() or global_registry()
    return (reg.render() if reg is not None else '',
            'text/plain; version=0.0.4', 200)


class ProfilingServer:
    """reference: pkg/profiling/pprof.go — starts only with -profile."""

    def __init__(self, port: int = 6060):
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 - quiet
                pass

            def _send(self, body: str, ctype='text/plain', code=200):
                data = body.encode()
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                path = parsed.path
                if path != '/' and path.endswith('/'):
                    path = path.rstrip('/')  # /debug/pprof/ == /debug/pprof
                if path in ('/debug', ''):
                    self._send(render_debug_index())
                    return
                route = _ROUTES.get(path)
                if route is None:
                    if path.startswith('/debug'):
                        # unknown debug path: 404 WITH the index, so a
                        # typo'd route answers with what exists
                        self._send('not found\n\n'
                                   + render_debug_index(), code=404)
                    else:
                        self._send('not found', code=404)
                    return
                try:
                    body, ctype, code = route.fn(parse_qs(parsed.query))
                except Exception as e:  # noqa: BLE001 - debug surface
                    self._send(f'internal error: {e}', code=500)
                    return
                self._send(body, ctype, code)

        self._httpd = ThreadingHTTPServer(('127.0.0.1', self.port),
                                          _Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name='ktpu-profiling', daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
