"""Partitioned compilation in the port (``KTPU_PARTITIONS > 0``): the
partition runtime (one evaluator per partition on the scanner's device)
and the composer, held against the port's monolithic scan, the JAX
package's partitioned scan (under the x64 shim) and the host engine;
the runtime's churn accounting, the fallback to the whole set, the
per-partition verdict cache and the controller's scoped rescan (the
cases of ``tests/test_partition.py``), and the verdict-cache engine
revision over the partition sources.  A ``cuda`` test runs the
partitioned scan on the card against the CPU port."""

import copy
import os
import random
import shutil

import pytest
import torch
import yaml

from test_partition import policy_raw, pod
from test_torch_reference import jax_reference  # noqa: F401
from test_torch_scan import NOW, _host_rows
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.observability.metrics import (MetricsRegistry,
                                                     set_global_registry)
from kyverno_tpu_torch.partition import census
from kyverno_tpu_torch.partition.plan import (PartitionError, build_plan,
                                              diff_plans)
from kyverno_tpu_torch.partition.runtime import (PARTITION_FALLBACKS,
                                                 PARTITION_RECOMPILES,
                                                 PARTITION_REUSES)

CHUNK = 64

PACKS = {
    'smoke': (smokepack.SMOKE_PACK, smokepack.make_config4_pod),
    'restricted': ('\n---\n'.join([smokepack.SMOKE_PACK,
                                   smokepack.RESTRICTED_FOREACH_PACK,
                                   smokepack.ADMISSION_LANES_PACK]),
                   smokepack.make_restricted_pod),
}
_HOST = {}


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    set_global_registry(reg)
    yield reg
    set_global_registry(None)


def _pack(name, n, seed=5):
    """(JAX-package policies, port policies, Pods) of ``name``."""
    from kyverno_tpu.api.policy import Policy as JaxPolicy
    docs = [d for d in yaml.safe_load_all(PACKS[name][0]) if d]
    rng = random.Random(seed)
    pods = [PACKS[name][1](rng, i) for i in range(n)]
    return [JaxPolicy(d) for d in docs], [Policy(d) for d in docs], pods


def _port_scanner(policies, monkeypatch, n_parts, device='cpu'):
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    monkeypatch.setenv('KTPU_PARTITIONS', str(n_parts))
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    sc = BatchScanner(policies, device=device)
    sc.CHUNK = CHUNK
    return sc


def _rows(scanner, pods):
    return [(r, s, [p.name for p in ps]) for r, s, ps in
            scanner.scan_report_results(copy.deepcopy(pods), now=NOW)]


@pytest.mark.parametrize('n_parts', [2, 3, 4])
@pytest.mark.parametrize('pack', sorted(PACKS))
def test_partitioned_scan_equals_monolithic_jax_and_host(
        pack, n_parts, jax_reference, monkeypatch):
    """The partitioned port scan, in several chunks, is byte-equal to
    the monolithic port scan, to the JAX package's partitioned scan and
    to the host engine."""
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    jp, tp, pods = _pack(pack, 150)
    mono = _rows(_port_scanner(tp, monkeypatch, 0), pods)
    sc = _port_scanner(tp, monkeypatch, n_parts)
    assert sc._pset is not None and sc._adm is None
    part = _rows(sc, pods)
    assert part == mono
    jsc = JaxScanner(jp)
    assert jsc._pset is not None
    assert [rt.part.policy_indices for rt in jsc._pset.runtimes] == \
        [rt.part.policy_indices for rt in sc._pset.runtimes]
    jsc.CHUNK = CHUNK
    jsc._encoder_pool.procs = 0  # no fork of a process holding jax
    assert part == _rows(jsc, pods)
    if pack not in _HOST:
        _HOST[pack] = _host_rows(jp, pods)
    assert [(r, s) for r, s, _ in part] == _HOST[pack]


def _policies(raws):
    return [Policy(r) for r in raws]


def test_edit_insert_delete_recompile_one_partition(registry):
    """A policy edit, an insertion and a deletion each recompile exactly
    the partition of the policy's bucket; every other partition's
    evaluator is reused."""
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.partition.runtime import (build_runtime,
                                                     clear_eval_cache)
    clear_eval_cache()
    raws = [policy_raw(i) for i in range(12)]

    def run(raws):
        pols = _policies(raws)
        before = (registry.counter_value(PARTITION_RECOMPILES),
                  registry.counter_value(PARTITION_REUSES))
        pset = build_runtime(pols, compile_policies(pols), 4, device='cpu')
        return pset, (registry.counter_value(PARTITION_RECOMPILES) -
                      before[0],
                      registry.counter_value(PARTITION_REUSES) - before[1])

    first, counts = run(raws)
    assert counts == (len(first.runtimes), 0)
    edited = copy.deepcopy(raws)
    edited[5]['spec']['rules'][0]['validate']['message'] = 'edited'
    inserted = raws + [policy_raw(12)]
    deleted = raws[:3] + raws[4:]
    for new_raws in (edited, inserted, deleted):
        pset, counts = run(new_raws)
        touched = diff_plans(first.plan, pset.plan).touched
        assert len(touched) == 1
        assert pset.recompiled() == list(touched)
        assert counts == (1, len(pset.runtimes) - 1)
        for rt in pset.runtimes:
            if rt.part.pid not in touched:
                old = next(o for o in first.runtimes
                           if o.part.pid == rt.part.pid)
                assert rt.evaluator is old.evaluator
    clear_eval_cache()


def test_evaluator_cache_is_keyed_by_device(monkeypatch):
    """An evaluator built for one device is never handed to a runtime on
    another (the card build is stubbed to record the device asked)."""
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.partition import runtime
    runtime.clear_eval_cache()
    pols = _policies([policy_raw(i) for i in range(6)])
    cps = compile_policies(pols)
    host = runtime.build_runtime(pols, cps, 2, device='cpu')
    asked = []
    real = ev.build_evaluator

    def fake_build(cps, device=None):
        asked.append(str(device))
        return real(cps, 'cpu')

    monkeypatch.setattr(ev, 'build_evaluator', fake_build)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    card = runtime.build_runtime(pols, cps, 2, device='cuda')
    assert asked == ['cuda'] * len(card.runtimes)
    assert not any(rt.reused for rt in card.runtimes)
    assert all(a.evaluator is not b.evaluator
               for a, b in zip(host.runtimes, card.runtimes))
    again = runtime.build_runtime(pols, cps, 2, device='cpu')
    assert all(rt.reused for rt in again.runtimes)
    runtime.clear_eval_cache()


def test_runtime_raises_without_cuda(monkeypatch):
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.partition.runtime import build_runtime
    pols = _policies([policy_raw(i) for i in range(3)])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_runtime(pols, compile_policies(pols), 2)


def test_partition_error_falls_back_to_the_whole_set(registry, monkeypatch):
    """A structural mismatch the composer finds leaves the scanner on
    the monolithic evaluator, counted, with the same rows."""
    from kyverno_tpu_torch.partition import compose

    def refuse(self, whole, runtimes):
        raise PartitionError('forced')

    _jp, tp, pods = _pack('smoke', 20)
    mono = _rows(_port_scanner(tp, monkeypatch, 0), pods)
    monkeypatch.setattr(compose.Composer, '__init__', refuse)
    sc = _port_scanner(tp, monkeypatch, 3)
    assert sc._pset is None and sc._composer is None
    assert registry.counter_value(PARTITION_FALLBACKS) == 1
    assert _rows(sc, pods) == mono


# ---------------------------------------------------------------------------
# the cases of tests/test_partition.py on the port


class TestPartitionedScan:
    def test_bit_identity_vs_monolithic(self, monkeypatch):
        import numpy as np
        resources = [pod(f'p{j}', {f'l{j % 12}': 'x'} if j % 2 else {})
                     for j in range(9)]
        mono = _port_scanner(_policies([policy_raw(i) for i in range(12)]),
                             monkeypatch, 0)
        assert mono._pset is None
        ms, md, mm = mono.scan_statuses(copy.deepcopy(resources))
        census.reset()
        part = _port_scanner(_policies([policy_raw(i) for i in range(12)]),
                             monkeypatch, 4)
        assert part._pset is not None and part._composer is not None
        assert part._adm is None
        ps, pd, pm = part.scan_statuses(copy.deepcopy(resources))
        assert np.array_equal(ms, ps)
        assert np.array_equal(md, pd)
        assert np.array_equal(mm, pm)
        rep = census.report()
        assert any(s['set_fingerprint'] == part.fingerprint
                   for s in rep['sets'])
        census.reset()

    def test_census_report_shape(self):
        census.reset()
        plan = build_plan(_policies([policy_raw(i) for i in range(6)]), 3)
        census.record_plan('fp-x', plan, serial=7,
                           diff=diff_plans(None, plan))
        census.record_swap('validate', 1, 2, breaker_state='open',
                           touched=[0])
        rep = census.report()
        assert rep['sets'][0]['serial'] == 7
        assert rep['sets'][0]['last_diff']['unchanged'] == []
        assert rep['swaps'][-1]['breaker_state'] == 'open'
        assert rep['swaps'][-1]['touched_partitions'] == [0]
        census.reset()

    def test_warmup_shapes_warms_every_partition(self, monkeypatch):
        sc = _port_scanner(_policies([policy_raw(i) for i in range(9)]),
                           monkeypatch, 3)
        warmed = sc.warmup_shapes([CHUNK])
        assert list(warmed) == [CHUNK]
        for rt in sc._pset.runtimes:
            assert len(rt.evaluator.plans) == 1
        assert len(sc._evaluator.plans) == 0  # the whole set never runs


class TestPartitionedVerdictCache:
    def _cache(self, n_pols=8, n_parts=3):
        from kyverno_tpu_torch.verdictcache.partitioned import \
            PartitionedVerdictCache
        pols = _policies([policy_raw(i) for i in range(n_pols)])
        plan = build_plan(pols, n_parts)
        return PartitionedVerdictCache(plan, pols), plan, pols

    def _row(self, pols, indexes, result='pass'):
        return [{'policy': pols[i].get_kind_and_name(),
                 'rule': f'l{i}-label', 'result': result,
                 'scored': True} for i in indexes]

    def test_store_lookup_roundtrip(self):
        vc, plan, pols = self._cache()
        results = self._row(pols, range(8))
        vc.store('d1', 'uid-1', results,
                 {'pass': 8, 'fail': 0, 'warn': 0, 'error': 0,
                  'skip': 0}, list(range(8)))
        row = vc.lookup('d1')
        assert row is not None
        assert [r['policy'] for r in row['r']] == \
            sorted(r['policy'] for r in results)
        assert row['s']['pass'] == 8 and row['s']['fail'] == 0
        assert row['p'] == list(range(8))
        assert vc.stats()['hits'] == 1

    def test_lookup_requires_every_partition(self):
        vc, plan, pols = self._cache()
        sub = next(iter(vc._parts.values()))
        vc.store('d2', 'u', self._row(pols, [0]),
                 {'pass': 1, 'fail': 0, 'warn': 0, 'error': 0,
                  'skip': 0}, [0])
        sub._rows.clear()
        assert vc.lookup('d2') is None
        assert vc.stats()['misses'] == 1

    def test_partial_and_merge_scoped(self):
        vc, plan, pols = self._cache()
        results = self._row(pols, range(8))
        vc.store('d3', 'uid-3', results,
                 {'pass': 8, 'fail': 0, 'warn': 0, 'error': 0,
                  'skip': 0}, list(range(8)))
        scoped_pid = plan.partitions[0].pid
        scoped_globals = list(plan.partitions[0].policy_indices)
        vc._parts[scoped_pid]._rows.clear()
        assert vc.lookup('d3') is None
        cached = vc.partial('d3', frozenset([scoped_pid]))
        assert cached is not None and scoped_pid not in cached
        assert vc.stats()['partial_hits'] == 1
        rescan = self._row(pols, scoped_globals, result='fail')
        merged, summary, gidx = vc.merge_scoped(
            'd3', 'uid-3', cached, rescan, None, scoped_globals,
            ts=1754000000)
        assert gidx == list(range(8))
        assert summary['fail'] == len(scoped_globals)
        assert summary['pass'] == 8 - len(scoped_globals)
        assert [r['policy'] for r in merged] == \
            sorted(r['policy'] for r in results)
        assert vc.lookup('d3') is not None

    def test_generation_carries_over_by_fingerprint(self):
        from kyverno_tpu_torch.verdictcache.partitioned import \
            PartitionedVerdictCache
        vc, plan, pols = self._cache()
        vc.store('d4', 'u4', self._row(pols, range(8)),
                 {'pass': 8, 'fail': 0, 'warn': 0, 'error': 0,
                  'skip': 0}, list(range(8)))
        raws = [policy_raw(i) for i in range(8)]
        edited = plan.partitions[0].policy_indices[0]
        raws[edited]['spec']['rules'][0]['validate']['message'] = 'x'
        pols2 = _policies(raws)
        plan2 = build_plan(pols2, 3)
        vc2 = PartitionedVerdictCache(plan2, pols2, prev=vc)
        touched = diff_plans(plan, plan2).touched
        for part in plan2.partitions:
            sub = vc2._parts[part.pid]
            if part.pid in touched:
                assert len(sub) == 0
            else:
                assert sub is vc._parts[part.pid]


def _controller(policies, jax=False):
    if jax:
        from kyverno_tpu.dclient.client import FakeClient
        from kyverno_tpu.reports.controllers import (
            BackgroundScanController, MetadataCache)
        ctrl = BackgroundScanController(FakeClient(), policies,
                                        cache=MetadataCache())
        ctrl.scanner._encoder_pool.procs = 0
        return ctrl
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.reports.controllers import (
        BackgroundScanController, MetadataCache)
    return BackgroundScanController(FakeClient(), policies,
                                    cache=MetadataCache(), device='cpu')


def _reports(ctrl):
    out = []
    for r in sorted(ctrl.client.list_resource(
            'kyverno.io/v1alpha2', 'BackgroundScanReport', 'default',
            None), key=lambda r: r['metadata']['name']):
        meta = {k: v for k, v in r['metadata'].items()
                if k not in ('resourceVersion', 'uid')}
        out.append(dict(r, metadata=meta))
    return out


class TestControllerChurn:
    NOW = 1754000000.0

    def test_churn_scoped_rescan_and_bit_identity(self, monkeypatch,
                                                  tmp_path, jax_reference):
        """Dense scan, replay, an edit's scoped rescan of the touched
        partition, replay again; every tick's reports equal the JAX
        controller's on the same ticks, and the last equal a monolithic
        scan with the cache off."""
        from kyverno_tpu.api.policy import Policy as JaxPolicy
        monkeypatch.setenv('KTPU_VERDICT_CACHE', '1')
        monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
        monkeypatch.setenv('KTPU_PARTITIONS', '4')
        raws = [policy_raw(i) for i in range(12)]
        pods = [pod(f'p{j}', {f'l{j % 12}': 'x'}) for j in range(20)]
        raws2 = copy.deepcopy(raws)
        raws2[5]['spec']['rules'][0]['validate']['message'] = 'edited'
        ctrls = {}
        for side, P in (('port', Policy), ('jax', JaxPolicy)):
            monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR',
                               str(tmp_path / side))
            ctrls[side] = _controller([P(r) for r in raws],
                                      jax=side == 'jax')
        ctrl, jctrl = ctrls['port'], ctrls['jax']
        assert ctrl.scanner._pset is not None

        def tick(now, edit=False, reset=False):
            for side, c in (('port', ctrl), ('jax', jctrl)):
                monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR',
                                   str(tmp_path / side))
                if edit:
                    c.set_policies([(Policy if side == 'port' else
                                     JaxPolicy)(r) for r in raws2])
                if reset:
                    c.reset_scan_state()
                if edit or reset:
                    c.enqueue_all()
                else:
                    for p in pods:
                        c.enqueue(copy.deepcopy(p))
                c.reconcile(now=now)
            assert ctrl.rescan_stats == jctrl.rescan_stats
            assert _reports(ctrl) == _reports(jctrl)

        tick(self.NOW)
        assert ctrl.rescan_stats['rows_scanned'] == 20
        tick(self.NOW + 60, reset=True)
        assert ctrl.rescan_stats['rows_replayed'] == 20
        tick(self.NOW + 120, edit=True)
        assert 0 < len(ctrl._scoped_pids) < ctrl._partition_plan.n_parts
        assert ctrl.rescan_stats['rows_scoped'] == 20
        tick(self.NOW + 180, reset=True)
        assert ctrl.rescan_stats['rows_replayed'] == 20
        monkeypatch.setenv('KTPU_PARTITIONS', '0')
        monkeypatch.setenv('KTPU_VERDICT_CACHE', '0')
        oracle = _controller(_policies(raws2))
        for p in pods:
            oracle.enqueue(p)
        oracle.reconcile(now=self.NOW + 180)
        assert _reports(ctrl) == _reports(oracle)

    def test_second_process_generations_replay(self, monkeypatch,
                                               tmp_path):
        monkeypatch.setenv('KTPU_VERDICT_CACHE', '1')
        monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))
        monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
        monkeypatch.setenv('KTPU_PARTITIONS', '3')
        raws = [policy_raw(i) for i in range(9)]
        pods = [pod(f'p{j}', {f'l{j % 9}': 'x'}) for j in range(10)]
        ctrl = _controller(_policies(raws))
        for p in pods:
            ctrl.enqueue(p)
        ctrl.reconcile(now=self.NOW)
        ctrl.verdict_cache.flush()
        ctrl2 = _controller(_policies(raws))
        for p in pods:
            ctrl2.enqueue(p)
        ctrl2.reconcile(now=self.NOW + 60)
        assert ctrl2.rescan_stats['rows_replayed'] == 10


# ---------------------------------------------------------------------------
# the verdict cache's engine revision


@pytest.mark.parametrize('rel', ['partition/compose.py',
                                 'partition/runtime.py'])
def test_engine_rev_covers_the_partition_sources(rel, tmp_path,
                                                 monkeypatch):
    """Composed rows land in the verdict cache, so an edit to how
    partitions are built or composed opens new generations: the engine
    revision digests both sources."""
    from kyverno_tpu_torch.verdictcache import keys
    assert rel in keys.ENGINE_SOURCES
    port = os.path.dirname(os.path.dirname(os.path.abspath(keys.__file__)))
    for src in keys.ENGINE_SOURCES:
        os.makedirs(tmp_path / os.path.dirname(src), exist_ok=True)
        shutil.copy(os.path.join(port, src), tmp_path / src)
    monkeypatch.setattr(keys, '__file__',
                        str(tmp_path / 'verdictcache' / 'keys.py'))
    monkeypatch.setattr(keys, '_ENGINE_REV', None)
    before = keys.engine_rev()
    with open(tmp_path / rel, 'a', encoding='utf-8') as f:
        f.write('\n# an edit\n')
    monkeypatch.setattr(keys, '_ENGINE_REV', None)
    assert keys.engine_rev() != before


# ---------------------------------------------------------------------------
# the card


@pytest.mark.cuda
@pytest.mark.parametrize('pack', sorted(PACKS))
def test_partitioned_scan_on_the_card_equals_the_cpu_port(pack,
                                                          monkeypatch):
    """Each partition's K1v program on the card, composed, against the
    same partitioned scan on the CPU (the eager walk): equal rows, and
    K1v launched once per partition per chunk."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels have no '
                    'CPU mode (their plain versions are tested here)')
    from kyverno_tpu_torch.ops import kernels
    _jp, tp, pods = _pack(pack, 200)
    host = _rows(_port_scanner(tp, monkeypatch, 4), pods)
    sc = _port_scanner(tp, monkeypatch, 4, device='cuda')
    assert sc._pset is not None
    kernels.reset_launches()
    card = _rows(sc, pods)
    chunks = -(-len(pods) // CHUNK)
    assert kernels.LAUNCHES['k1_vm'] == len(sc._pset.runtimes) * chunks
    assert card == host
