"""The port's executable ledger (``observability/executables.py``): a
record per K1v program, lowered once per (evaluator, pack layout) by
``evaluator.plan_for`` and tagged with the evaluator's fingerprint — a
partition's in partitioned mode, which the partition census
(``partition/census.py``) attributes by — with the program's costs in
place of XLA's cost analysis; dispatches accounted per K1 call.  The
ledger's own behaviour (the cases of ``tests/test_executables.py``),
and ``/debug/executables`` and ``/debug/partitions`` through the
profiling server."""

import copy
import json
import urllib.error
import urllib.request

import pytest

from test_partition import policy_raw, pod
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.observability import executables, tracing
from kyverno_tpu_torch.observability.executables import (
    EXEC_COUNT, EXEC_DEVICE_SECONDS, EXEC_DISPATCHES, ExecutableLedger)
from kyverno_tpu_torch.observability.metrics import MetricsRegistry
from kyverno_tpu_torch.partition import census


@pytest.fixture(autouse=True)
def _clean_modules(tmp_path, monkeypatch):
    # a store of this test's own: programs that another process stored
    # in the shared default directory would load here as ``aot_load``
    from kyverno_tpu_torch.aotcache.store import reset_default_store
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    reset_default_store()
    yield
    from kyverno_tpu_torch.compiler import aot
    aot.flush_stores()
    reset_default_store()
    executables.disable()
    tracing.disable()
    census.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class TestLedger:
    def test_build_dispatch_evict_roundtrip(self):
        reg = MetricsRegistry()
        led = ExecutableLedger(8, registry=reg, now=FakeClock())
        led.record_build('k1', fingerprint='f' * 20, capacity=0,
                         source='fresh_compile', build_s=2.5)
        led.record_dispatch('k1', 0.25)
        led.record_dispatch('k1', 0.25)
        rec = led.records()[0]
        assert rec.dispatches == 2
        assert abs(rec.device_s - 0.5) < 1e-9
        assert reg.gauge_value(EXEC_COUNT, source='fresh_compile') == 1.0
        assert reg.counter_value(EXEC_DISPATCHES,
                                 source='fresh_compile') == 2.0
        assert abs(reg.counter_value(EXEC_DEVICE_SECONDS,
                                     source='fresh_compile') - 0.5) < 1e-9
        led.record_eviction('k1', 'execute_failed')
        rec = led.records()[0]
        assert rec.evicted and rec.evict_reason == 'execute_failed'
        assert reg.gauge_value(EXEC_COUNT, source='fresh_compile') == 0.0
        assert led.report()['executables'][0]['evicted'] is True

    def test_unknown_key_dispatch_and_eviction_are_noops(self):
        led = ExecutableLedger(8, registry=None)
        led.record_dispatch('nope', 1.0)
        led.record_eviction('nope', 'whatever')
        assert led.records() == []

    def test_lru_bound(self):
        led = ExecutableLedger(2, registry=None)
        for k in ('a', 'b', 'c'):
            led.record_build(k, source='fresh_compile')
        assert [r.key for r in led.records()] == ['b', 'c']
        led.record_dispatch('b', 0.1)
        led.record_build('d', source='fresh_compile')
        assert [r.key for r in led.records()] == ['b', 'd']

    def test_reacquisition_keeps_dispatch_history(self):
        led = ExecutableLedger(8, registry=None)
        led.record_build('k', source='fresh_compile', build_s=3.0)
        led.record_dispatch('k', 0.5)
        led.record_build('k', source='aot_load', build_s=0.2)
        rec = led.records()[0]
        assert rec.source == 'aot_load' and rec.build_s == 0.2
        assert rec.dispatches == 1

    def test_census_report_and_table(self):
        led = ExecutableLedger(8, registry=None)
        led.record_build('k1', source='fresh_compile', build_s=2.0)
        led.record_build('k2', source='aot_load', build_s=0.5)
        led.record_dispatch('k1', 0.125)
        led.record_eviction('k2', 'feature_mismatch')
        c = led.census()
        assert c['live'] == 1 and c['by_source'] == {'fresh_compile': 1}
        assert c['dispatches'] == 1 and abs(c['build_s'] - 2.0) < 1e-9
        rep = led.report()
        assert rep['enabled'] is True and rep['capacity'] == 8
        assert len(rep['executables']) == 2
        table = led.render_table()
        assert 'fresh_compile' in table
        assert 'evicted:feature_mismatch' in table

    def test_lifecycle_events_ride_the_tracer(self):
        exporter = tracing.configure()
        led = ExecutableLedger(8, registry=None)
        led.record_build('k1', fingerprint='abc', source='fresh_compile',
                         build_s=0.7)
        led.record_eviction('k1', 'execute_failed')
        assert [s.name for s in exporter.spans()] == [
            'kyverno/executable/build', 'kyverno/executable/evict']
        evict = exporter.spans()[-1]
        assert evict.attributes['evict_reason'] == 'execute_failed'
        assert evict.end_ns >= evict.start_ns

    def test_noop_until_configured_and_env_zero(self, monkeypatch):
        assert not executables.enabled()
        executables.record_build('k', source='fresh_compile')
        executables.record_dispatch('k', 1.0)
        assert executables.census() == {}
        monkeypatch.setenv('KTPU_EXEC_LEDGER_N', '0')
        assert executables.configure() is None
        assert not executables.enabled()


def _scanner(policies, monkeypatch, n_parts):
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    monkeypatch.setenv('KTPU_PARTITIONS', str(n_parts))
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    sc = BatchScanner(policies, device='cpu')
    sc.CHUNK = 64
    return sc


def _pods(n):
    return [pod(f'p{j}', {f'l{j % 12}': 'x'} if j % 2 else {})
            for j in range(n)]


def test_cost_analysis_reads_the_k1v_program(monkeypatch):
    """A record's costs are its K1v program's: instructions and lane
    bytes per row (what the card's bound uses), output bytes, entries,
    parts, groups and staged shared memory."""
    executables.configure(registry=MetricsRegistry(), ledger_n=16)
    sc = _scanner([Policy(policy_raw(i)) for i in range(6)], monkeypatch, 0)
    sc.scan_statuses(_pods(9))
    (rec,) = executables.ledger().records()
    (plan,) = sc._evaluator.plans.values()
    program = plan.program
    assert rec.key == plan.ledger_key
    assert rec.source == 'fresh_compile' and rec.capacity == 0
    assert rec.fingerprint == sc._evaluator.fingerprint
    assert rec.costs == executables.cost_analysis(program)
    assert rec.costs['row_insns'] == program.row_insns > 0
    assert rec.costs['row_bytes'] == program.row_bytes > 0
    assert rec.costs['groups'] == program.n_groups
    assert rec.costs['parts'] == sum(program.tree_parts.values())
    assert rec.costs['smem_bytes'] == program.smem_bytes
    out = rec.to_dict()
    assert out['row_insns'] == program.row_insns
    assert executables.cost_analysis(None) == {}


def test_one_record_per_evaluator_and_layout(monkeypatch):
    """Whole set: one record per pack layout, every K1 call a dispatch
    of its layout's record; two layouts (a wider element axis) give two
    records."""
    import random
    from kyverno_tpu_torch import smokepack
    executables.configure(registry=MetricsRegistry(), ledger_n=16)
    sc = _scanner(smokepack.load_smoke_pack(), monkeypatch, 0)
    rng = random.Random(1)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(150)]
    for p in pods:  # one element width: three chunks, one layout
        p['spec']['containers'] = p['spec']['containers'][:1]
    sc.scan_statuses(copy.deepcopy(pods))
    recs = executables.ledger().records()
    assert len(recs) == len(sc._evaluator.plans) == 1
    assert recs[0].dispatches == 3
    wide = copy.deepcopy(pods[:5])
    wide[0]['spec']['containers'] *= 9
    sc.scan_statuses(wide)
    recs = executables.ledger().records()
    assert len(recs) == len(sc._evaluator.plans) == 2
    assert sorted(r.dispatches for r in recs) == [1, 3]
    assert {r.fingerprint for r in recs} == {sc._evaluator.fingerprint}


def test_partitioned_records_carry_partition_fingerprints(monkeypatch):
    """Partitioned: one record per (partition, layout) under the
    partition's fingerprint, none for the whole-set evaluator; the
    census attributes every record to its partition."""
    from kyverno_tpu_torch.partition.runtime import clear_eval_cache
    clear_eval_cache()
    census.reset()
    executables.configure(registry=MetricsRegistry(), ledger_n=32)
    sc = _scanner([Policy(policy_raw(i)) for i in range(12)], monkeypatch, 4)
    sc.scan_statuses(_pods(150))
    recs = executables.ledger().records()
    fps = {rt.evaluator.fingerprint: rt for rt in sc._pset.runtimes}
    assert {r.fingerprint for r in recs} == set(fps)
    assert sc._evaluator.fingerprint not in {r.fingerprint for r in recs}
    for fp, rt in fps.items():
        assert fp == rt.part.fingerprint
        mine = [r for r in recs if r.fingerprint == fp]
        assert len(mine) == len(rt.evaluator.plans) == 1
        assert mine[0].dispatches == 3
    rep = census.report()
    (s,) = rep['sets']
    assert s['set_fingerprint'] == sc.fingerprint
    live = [p for p in s['partitions'] if p['fingerprint'] in fps]
    assert [p['executables']['executables'] for p in live] == \
        [1] * len(fps)
    assert rep['unattributed']['executables'] == 0
    clear_eval_cache()


def _get(srv, path):
    url = f'http://127.0.0.1:{srv.port}{path}'
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get('Content-Type'), \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get('Content-Type'), e.read().decode()


def test_debug_routes_answer_through_the_profiling_server(monkeypatch):
    """``/debug/executables`` and ``/debug/partitions`` serve the
    ledger and the partition census of a partitioned scan."""
    from kyverno_tpu_torch.observability.profiling import ProfilingServer
    from kyverno_tpu_torch.partition.runtime import clear_eval_cache
    clear_eval_cache()
    census.reset()
    srv = ProfilingServer(port=0)
    srv.start()
    try:
        code, _, body = _get(srv, '/debug/executables')
        assert code == 200 and json.loads(body) == {'enabled': False}
        executables.configure(registry=MetricsRegistry(), ledger_n=16)
        sc = _scanner([Policy(policy_raw(i)) for i in range(6)],
                      monkeypatch, 2)
        sc.scan_statuses(_pods(9))
        code, _, body = _get(srv, '/debug/executables')
        out = json.loads(body)
        assert code == 200 and out['enabled'] is True
        assert out['census']['live'] == len(sc._pset.runtimes)
        assert all(e['row_insns'] > 0 for e in out['executables'])
        code, ctype, body = _get(srv, '/debug/executables?format=table')
        assert code == 200 and ctype.startswith('text/plain')
        assert 'fresh_compile' in body
        code, _, body = _get(srv, '/debug/partitions')
        rep = json.loads(body)
        assert code == 200
        assert rep['sets'][0]['set_fingerprint'] == sc.fingerprint
        assert sum(p['executables']['executables']
                   for p in rep['sets'][0]['partitions']) == \
            len(sc._pset.runtimes)
    finally:
        srv.stop()
        clear_eval_cache()
