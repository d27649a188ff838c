"""The scan's telemetry in the port (``observability/device.py``): the
report loop's ``wait``, the ``match`` stage, garbage-collector pauses,
each stage's thread CPU seconds and the K1 call's device time from CUDA
events, all through the stage seam; stages on the profiler's clock; a
``ScanCapture`` that a reader may copy while pipeline threads add to
it; and nothing of it running while telemetry is off.  On the CPU, so
no device time is ever written."""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from test_torch_reference import load_pack, make_resources
from kyverno_tpu_torch.observability import catalog
from kyverno_tpu_torch.observability import device as devtel
from kyverno_tpu_torch.observability import tracing
from kyverno_tpu_torch.observability.metrics import MetricsRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 64
NOW = 1_700_000_000


@pytest.fixture
def telemetry_off():
    """No registry, no tracer, no capture: the state of an untraced
    run; restored whatever the test switched on."""
    devtel.disable()
    tracing.disable()
    yield
    devtel.disable()
    tracing.disable()


def _scanner(procs=0):
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    _jpols, tpols = load_pack('smoke')
    old = os.environ.get('KTPU_ENCODE_PROCS')
    os.environ['KTPU_ENCODE_PROCS'] = str(procs)
    try:
        sc = BatchScanner(tpols, device='cpu')
    finally:
        if old is None:
            del os.environ['KTPU_ENCODE_PROCS']
        else:
            os.environ['KTPU_ENCODE_PROCS'] = old
    sc.CHUNK = CHUNK
    return sc


def _rows(sc, pods):
    return json.dumps([(r, s, [p.name for p in pols]) for r, s, pols in
                       sc.scan_report_results(pods, now=NOW)],
                      sort_keys=True)


def test_untraced_scan_runs_no_new_work(telemetry_off, monkeypatch):
    """Two chunks with telemetry off: the shared no-op stage, no gc
    hook, no CUDA event, no CPU clock read."""
    sc = _scanner()
    pods = make_resources('smoke', 2 * CHUNK, seed=3)
    calls = {'hook': 0, 'event': 0, 'cpu': 0}

    def count(key, real):
        def spy(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return spy

    monkeypatch.setattr(devtel, '_hook_gc', count('hook', devtel._hook_gc))
    monkeypatch.setattr(torch.cuda, 'Event', count('event', torch.cuda.Event))
    monkeypatch.setattr(time, 'thread_time', count('cpu', time.thread_time))
    monkeypatch.setattr(time, 'process_time',
                        count('cpu', time.process_time))

    class CudaTensor:
        is_cuda = True
        device = 'cuda:0'

    assert devtel.device_timer(CudaTensor()) is None
    assert devtel.stage('wait') is devtel._NOOP_STAGE
    assert devtel.stage('match', {'rows': 1}) is devtel._NOOP_STAGE
    rows = list(sc.scan_report_results(pods, now=NOW))
    assert len(rows) == len(pods)
    assert calls == {'hook': 0, 'event': 0, 'cpu': 0}
    assert devtel._on_gc not in gc.callbacks


_POOL_CHILD = r'''
import json, os, random, sys
sys.path.insert(0, sys.argv[1])
os.environ['KTPU_ENCODE_PROCS'] = '2'
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.compiler.scan import BatchScanner
from kyverno_tpu_torch.observability import device as devtel
policies = smokepack.load_smoke_pack()
rng = random.Random(13)
pods = [smokepack.make_config4_pod(rng, i) for i in range(2 * 64 + 5)]
sc = BatchScanner(policies, device='cpu')
sc.CHUNK = 64
sc.ENCODE_TIMEOUT_S = 60.0
sc.start_encoder_pool()
cap = devtel.ScanCapture()
with devtel.install_capture(cap):
    rows = [(r, s) for r, s, _p in sc.scan_report_results(pods, now=1)]
pool = sc._encoder_pool
assert pool._pool is not None and not pool._broken
pool.close()
print(json.dumps({'rows': len(rows), 'stages': cap.stages}))
'''


@pytest.fixture(scope='module')
def pooled_scan():
    """Stages of a traced two-chunk scan with the forked encoder pool,
    in a fresh interpreter without jax (as the port runs)."""
    proc = subprocess.run([sys.executable, '-c', _POOL_CHILD, ROOT],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_traced_scan_with_the_encoder_pool_fills_the_new_stages(
        pooled_scan):
    stages = pooled_scan['stages']
    assert pooled_scan['rows'] == 2 * 64 + 5
    for key in ('match', 'wait', 'encode', 'encode.cpu', 'report',
                'report.cpu', 'd2h', 'd2h.cpu', 'match.cpu', 'wait.cpu'):
        assert key in stages, (key, sorted(stages))
    assert stages['match'] > 0 and stages['wait'] > 0
    # off the card the program writes no device time
    assert 'device' not in stages


def test_traced_cpu_seconds_stay_within_their_threads_budget(pooled_scan):
    """A stage's thread CPU seconds never pass its wall seconds (a
    worker's encode CPU is its whole process's, held to a margin)."""
    stages = pooled_scan['stages']
    for key, cpu in stages.items():
        if not key.endswith('.cpu'):
            continue
        wall = stages[key[:-4]]
        margin = 0.05 * wall + 0.02 if key == 'encode.cpu' \
            else 0.01 * wall + 1e-3
        assert 0 <= cpu <= wall + margin, (key, cpu, wall)


def test_a_forced_collection_adds_to_gc_once(telemetry_off):
    """``gc.collect()`` while the scan's pipeline threads hold the
    capture: its pause lands once, however many threads hold it, and on
    the pause counter under its generation."""
    sc = _scanner()
    pods = make_resources('smoke', 3 * CHUNK, seed=5)
    reg = devtel.configure(MetricsRegistry())
    pauses = []
    t0 = []

    def watch(phase, info):
        if phase == 'start':
            t0.append(time.time_ns())
        elif t0 and info['generation'] == 2:
            pauses.append((time.time_ns() - t0.pop()) / 1e9)
        elif t0:
            t0.pop()

    cap = devtel.ScanCapture()
    gc.callbacks.append(watch)
    try:
        with devtel.install_capture(cap):
            stream = sc.scan_report_results(pods, now=NOW)
            next(stream)
            held = devtel._live[id(cap)][1]
            devtel._drain()
            g0 = cap.stages.get('gc', 0.0)
            c0 = reg.counter_value(devtel.GC_PAUSE, generation='2')
            gc.collect()
            g1 = cap.stages.get('gc', 0.0)
            devtel._drain()
            c1 = reg.counter_value(devtel.GC_PAUSE, generation='2')
            rest = list(stream)
    finally:
        gc.callbacks.remove(watch)
    assert held > 1
    assert len(rest) == len(pods) - 1
    assert pauses, 'the forced collection was not seen'
    pause = pauses[-1]
    # other threads' young collections may fall in between, each far
    # shorter than a full one; held-times counting would read >= 2x
    assert 0.5 * pause <= g1 - g0 <= 1.5 * pause + 2e-3
    assert 0.5 * pause <= c1 - c0 <= 1.5 * pause + 2e-3
    # a collector pause reads no CPU clock (it is all CPU)
    assert 'gc.cpu' not in cap.stages


def test_snapshots_never_race_writers_adding_keys():
    """Readers copy ``stages`` with ``dict()`` while more threads than
    cores add new keys; no copy raises and no update is lost."""
    cap = devtel.ScanCapture()
    writers, adds, keys = 2 * (os.cpu_count() or 4), 400, 5
    errors = []
    stop = threading.Event()

    def write(w):
        for i in range(adds):
            cap.add(f'k{w}.{i % keys}', 1.0, cpu=0.5)
            cap.add('shared', 1.0)

    def read():
        while not stop.is_set():
            try:
                snap = cap.stages
                dict(snap)
                total = 0.0
                for _key, value in snap.items():
                    total += value
            except RuntimeError as e:  # dict changed size during iteration
                errors.append(e)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=read) for _ in range(2)]
        threads = [threading.Thread(target=write, args=(w,))
                   for w in range(writers)]
        for t in readers + threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers + threads)
    assert errors == []
    stages = cap.stages
    assert stages['shared'] == writers * adds
    for w in range(writers):
        for k in range(keys):
            assert stages[f'k{w}.{k}'] == adds // keys
            assert stages[f'k{w}.{k}.cpu'] == adds // keys / 2


def test_a_stage_is_a_profiler_range_on_the_spans_clock(telemetry_off,
                                                         tmp_path):
    from torch.profiler import ProfilerActivity, profile
    mem = tracing.configure()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with devtel.stage('pack'):
            time.sleep(0.005)
    span = mem.find('kyverno/device/pack')[-1]
    assert [e for e in prof.events() if e.name == 'kyverno/device/pack']
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ev = [e for e in trace['traceEvents']
          if e.get('name') == 'kyverno/device/pack']
    assert len(ev) == 1
    start_ns = ev[0]['ts'] * 1e3 + trace.get('baseTimeNanoseconds', 0)
    assert abs(start_ns - span.start_ns) < 2e6


def test_stage_seconds_are_the_spans_own_interval(telemetry_off):
    mem = tracing.configure()
    reg = devtel.configure(MetricsRegistry())
    cap = devtel.ScanCapture()
    with devtel.install_capture(cap):
        with devtel.stage('pack'):
            time.sleep(0.002)
        with devtel.stage('wait'):
            time.sleep(0.002)
    for name in ('pack', 'wait'):
        span = mem.find(f'kyverno/device/{name}')[-1]
        assert cap.stages[name] == (span.end_ns - span.start_ns) / 1e9
        assert reg.histogram_sum(devtel.SCAN_STAGE_DURATION,
                                 stage=name) == cap.stages[name]
        assert reg.counter_value(devtel.SCAN_STAGE_CPU, stage=name) == \
            cap.stages[name + '.cpu']


def test_wait_spans_parent_nothing(telemetry_off):
    """The report loop's wait drives the pipeline's generator: the
    stages it runs parent under the scan's span, not under the wait."""
    mem = tracing.configure()
    sc = _scanner()
    pods = make_resources('smoke', CHUNK // 2, seed=9)
    with tracing.tracer().start_span('kyverno/rescan') as root:
        assert len(list(sc.scan_report_results(pods, now=NOW))) == len(pods)
    waits = {s.span_id for s in mem.find('kyverno/device/wait')}
    assert waits
    assert all(s.parent_id not in waits for s in mem.spans())
    chunk = mem.find('kyverno/device/chunk')
    assert chunk and chunk[0].parent_id == root.span_id


def test_report_rows_are_byte_identical_with_telemetry_on_and_off(
        telemetry_off):
    sc = _scanner()
    pods = make_resources('smoke', 2 * CHUNK + 7, seed=11)
    off = _rows(sc, pods)
    tracing.configure()
    devtel.configure(MetricsRegistry())
    cap = devtel.ScanCapture()
    with devtel.install_capture(cap):
        on = _rows(sc, pods)
    assert on == off
    assert {'match', 'wait', 'report'} <= set(cap.stages)


def test_device_time_is_written_only_from_a_timer(telemetry_off):
    class Timer:
        def seconds(self):
            return 0.003

    cap = devtel.ScanCapture()
    cpu_tensor = torch.zeros(4)
    with devtel.install_capture(cap):
        # a tensor off the card gets no timer, so no device time
        assert devtel.device_timer(cpu_tensor) is None
        devtel.merge_device_time(None)
        assert 'device' not in cap.stages
        devtel.merge_device_time(Timer())
        devtel.merge_device_time(Timer())
    assert cap.stages['device'] == pytest.approx(0.006)


def test_a_forked_child_inherits_no_gc_hook(telemetry_off):
    cap = devtel.ScanCapture()
    with devtel.install_capture(cap):
        assert devtel._on_gc in gc.callbacks
        pid = os.fork()
        if pid == 0:  # the child: report and leave at once
            os._exit(0 if devtel._on_gc not in gc.callbacks
                     and not devtel._live else 1)
        _pid, status = os.waitpid(pid, 0)
    assert os.waitstatus_to_exitcode(status) == 0
    assert devtel._on_gc not in gc.callbacks


def test_every_new_name_is_in_the_catalog():
    for name in ('match', 'wait', 'gc'):
        assert name in catalog.PIPELINE_STAGES
        assert f'kyverno/device/{name}' in catalog.SPANS
    for metric in (devtel.SCAN_STAGE_CPU, devtel.GC_PAUSE):
        assert catalog.METRICS[metric].type == 'counter'
    assert 'compile' not in devtel.STAGES
    assert 'compile' not in catalog.PIPELINE_STAGES
    assert 'kyverno/device/compile' not in catalog.SPANS
    assert set(devtel.STAGES) <= set(catalog.PIPELINE_STAGES)


def test_overlap_ratio_sums_the_pipelines_work_stages_only(
        telemetry_off, monkeypatch, tmp_path):
    """A tick's ``overlap_ratio`` is the pipeline's work over the scan's
    wall: the report loop's wait, collector pauses, device time and CPU
    seconds in the same capture do not count as busy."""
    import random

    import yaml
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.api.policy import Policy
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.reports.controllers import (
        BackgroundScanController, MetadataCache)
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    monkeypatch.setenv('KTPU_PARTITIONS', '0')
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))

    class Padded(devtel.ScanCapture):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            self.stages = {'wait': 1e3, 'gc': 1e3, 'device': 1e3,
                           'report.cpu': 1e3}

    monkeypatch.setattr(devtel, 'ScanCapture', Padded)
    mem = tracing.configure()
    docs = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    ctrl = BackgroundScanController(FakeClient(), [Policy(d) for d in docs],
                                    cache=MetadataCache(), device='cpu')
    rng = random.Random(4)
    for i in range(40):
        pod = smokepack.make_config4_pod(rng, i)
        pod['metadata']['uid'] = f'uid-{i}'
        ctrl.enqueue(pod)
    assert len(ctrl.reconcile(now=NOW)) == 40
    ratio = mem.find('kyverno/rescan')[-1].attributes['overlap_ratio']
    assert 0 < ratio < 50
