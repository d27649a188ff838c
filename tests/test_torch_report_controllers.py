"""The port's reports controller (``reports/controllers.py``) and its
daemon (``cmd/reports_controller.py``) on the CPU, held against the JAX
package's (under the x64 shim) on the same cluster, Pods and ticks with
``now`` pinned: the background scan with the verdict cache on and off
over cold, replay, churn and policy-edit ticks, delete invalidation, a
second process replaying from the disk store, the daemon's tick, and
the cases of ``tests/test_report_controllers.py`` and
``tests/test_report_fusion.py``."""

import copy
import json
import os
import random
import subprocess
import sys

import pytest
import torch
import yaml

from test_report_controllers import POLICY, pod
from test_torch_reference import jax_reference  # noqa: F401
from test_verdict_cache import OTHER_POLICY
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.observability.metrics import (MetricsRegistry,
                                                     set_global_registry)

NOW = 1754000000.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A registry of the test's own, no encoder fork, and the verdict
    cache under ``tmp_path`` (its default is the repository's
    ``.cache/verdicts``)."""
    reg = MetricsRegistry()
    set_global_registry(reg)
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    monkeypatch.setenv('KTPU_PARTITIONS', '0')
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))
    yield reg
    set_global_registry(None)


def _smoke(n, seed=3):
    docs = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    rng = random.Random(seed)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(n)]
    for i, p in enumerate(pods):
        p['metadata']['uid'] = f'uid-{i}'
    return docs, pods


def _controller(docs, side):
    """A background-scan controller of ``side`` ('port' or 'jax') over
    its package's FakeClient and policies."""
    if side == 'jax':
        from kyverno_tpu.api.policy import Policy as P
        from kyverno_tpu.dclient.client import FakeClient
        from kyverno_tpu.reports.controllers import (
            BackgroundScanController, MetadataCache)
        ctrl = BackgroundScanController(FakeClient(), [P(d) for d in docs],
                                        cache=MetadataCache())
        ctrl.scanner._encoder_pool.procs = 0
        return ctrl
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.reports.controllers import (
        BackgroundScanController, MetadataCache)
    return BackgroundScanController(FakeClient(), [Policy(d) for d in docs],
                                    cache=MetadataCache(), device='cpu')


def _policy_class(side):
    if side == 'jax':
        from kyverno_tpu.api.policy import Policy as P
        return P
    return Policy


def reports_of(ctrl, namespace=''):
    """Stored BackgroundScanReports, the fake API server's own write
    bookkeeping (resourceVersion, server-assigned uid) left out."""
    out = []
    for r in sorted(ctrl.client.list_resource(
            'kyverno.io/v1alpha2', 'BackgroundScanReport', namespace,
            None), key=lambda r: (r['metadata'].get('namespace', ''),
                                  r['metadata']['name'])):
        out.append(dict(r, metadata={
            k: v for k, v in r['metadata'].items()
            if k not in ('resourceVersion', 'uid')}))
    return out


@pytest.mark.parametrize('cache', ['on', 'off'])
def test_ticks_equal_the_jax_controller(cache, jax_reference, monkeypatch,
                                        tmp_path):
    """Cold, replay, churn (one Pod changed, one deleted) and
    policy-edit ticks of the port's controller and the JAX package's
    over the smoke pack: the same reports and rescan stats after every
    tick; with the cache on the replay tick scans nothing."""
    monkeypatch.setenv('KTPU_VERDICT_CACHE', '1' if cache == 'on' else '0')
    docs, pods = _smoke(40)
    edited = copy.deepcopy(docs)
    edited[1]['spec']['rules'][0]['validate']['message'] += ' (edited)'
    ctrls = {}
    for side in ('port', 'jax'):
        monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / side))
        ctrls[side] = _controller(docs, side)
    assert (ctrls['port'].verdict_cache is None) == (cache == 'off')

    def tick(now, step):
        for side, ctrl in ctrls.items():
            monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR',
                               str(tmp_path / side))
            step(side, ctrl)
            ctrl.reconcile(now=now)
        assert ctrls['port'].rescan_stats == ctrls['jax'].rescan_stats
        assert reports_of(ctrls['port']) == reports_of(ctrls['jax'])
        return ctrls['port'].rescan_stats

    def cold(side, ctrl):
        for p in pods:
            ctrl.enqueue(copy.deepcopy(p))

    def replay(side, ctrl):
        ctrl.reset_scan_state()
        ctrl.enqueue_all()

    def churn(side, ctrl):
        changed = copy.deepcopy(pods[3])
        changed['metadata']['labels'] = {}
        ctrl.cache.update(changed)
        ctrl.cache.remove(copy.deepcopy(pods[7]))
        replay(side, ctrl)

    def edit(side, ctrl):
        ctrl.set_policies([_policy_class(side)(d) for d in edited])
        ctrl.enqueue_all()

    assert tick(NOW, cold)['rows_scanned'] == 40
    st = tick(NOW + 30, replay)
    assert st['rows_replayed'] == (40 if cache == 'on' else 0)
    st = tick(NOW + 60, churn)
    assert st['rows_pending'] == 39
    assert st['rows_scanned'] == (1 if cache == 'on' else 39)
    st = tick(NOW + 90, edit)
    assert st['rows_scanned'] == 39 and st['rows_replayed'] == 0


def test_delete_drops_verdict_entries():
    docs = [POLICY]
    ctrl = _controller(docs, 'port')
    p = pod('gone', team='infra')
    ctrl.enqueue(p)
    ctrl.reconcile(now=NOW)
    assert len(ctrl.verdict_cache) == 1
    ctrl.cache.remove(p)
    assert len(ctrl.verdict_cache) == 0


def test_policy_change_opens_new_generation():
    ctrl = _controller([POLICY], 'port')
    ctrl.enqueue(pod('p', team='infra'))
    ctrl.reconcile(now=NOW)
    gen_before = ctrl.verdict_cache.fingerprint
    ctrl.set_policies([Policy(OTHER_POLICY)])
    assert ctrl.verdict_cache.fingerprint != gen_before
    ctrl.enqueue(pod('p', team='infra'))
    ctrl.reconcile(now=NOW + 60)
    assert ctrl.rescan_stats['rows_scanned'] == 1
    assert ctrl.rescan_stats['rows_replayed'] == 0


_SECOND = r'''
import json, sys
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.dclient.client import FakeClient
from kyverno_tpu_torch.reports.controllers import (BackgroundScanController,
                                                   MetadataCache)
docs, pods, now = json.loads(sys.stdin.read())
ctrl = BackgroundScanController(FakeClient(), [Policy(d) for d in docs],
                                cache=MetadataCache(), device='cpu')
ctrl.scanner.scan_report_results = None   # a replay must not scan
for p in pods:
    ctrl.enqueue(p)
ctrl.reconcile(now=now)
print(json.dumps([ctrl.rescan_stats, sorted(
    (r['metadata']['name'], r['spec']) for r in ctrl.client.list_resource(
        'kyverno.io/v1alpha2', 'BackgroundScanReport', '', None))]))
'''


def test_second_process_replays_from_the_disk_store(tmp_path):
    """A controller in another process, over the same cache directory
    and policy set, replays every row from the snapshot the first one
    persisted, with the same reports and no scan."""
    docs, pods = _smoke(12)
    first = _controller(docs, 'port')
    for p in pods:
        first.enqueue(p)
    first.reconcile(now=NOW)
    first.close()
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', _SECOND],
                         input=json.dumps([docs, pods, NOW]), env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    stats, reports = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats == {'rows_pending': 12, 'rows_scanned': 0,
                     'rows_replayed': 12}
    want = sorted((r['metadata']['name'], r['spec'])
                  for r in first.client.list_resource(
                      'kyverno.io/v1alpha2', 'BackgroundScanReport', '',
                      None))
    assert [list(r) for r in want] == reports


def test_controller_raises_without_cuda(monkeypatch):
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.reports.controllers import \
        BackgroundScanController
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        BackgroundScanController(FakeClient(), [Policy(POLICY)])


# ---------------------------------------------------------------------------
# the daemon


def _daemon(side, client, device='cpu'):
    if side == 'jax':
        from kyverno_tpu.cmd.internal import Setup
        from kyverno_tpu.cmd.reports_controller import ReportsController
        return ReportsController(Setup('kyverno-reports-controller', [],
                                       client=client))
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.cmd.reports_controller import ReportsController
    return ReportsController(Setup('kyverno-reports-controller', [],
                                   client=client), device=device)


@pytest.fixture
def telemetry_off():
    """The daemons' Setup configures process-wide telemetry; put both
    packages' back off afterwards."""
    yield
    from kyverno_tpu.observability import (coverage as jc, device as jd,
                                           executables as je, fleet as jf,
                                           metrics as jm, provenance as jp,
                                           slo as js)
    from kyverno_tpu_torch.observability import (coverage, device,
                                                 executables, fleet,
                                                 provenance, slo)
    for mod in (jc, jd, je, jf, jp, js, coverage, device, executables,
                fleet, provenance, slo):
        mod.disable()
    jm.set_global_registry(None)
    set_global_registry(None)


def test_daemon_tick_equals_the_jax_daemon(jax_reference, telemetry_off,
                                           monkeypatch, tmp_path):
    """``ReportsController.tick()`` of both packages over the same
    cluster (the smoke pack as ClusterPolicies, seeded Pods in three
    namespaces): the same BackgroundScanReports (timestamps aside: each
    daemon stamps its own clock) and PolicyReports; a policy edit
    through the client rescans every row in both."""
    docs, pods = _smoke(30)
    clients = {}
    for side in ('port', 'jax'):
        mod = __import__('kyverno_tpu_torch.dclient.client' if side == 'port'
                         else 'kyverno_tpu.dclient.client',
                         fromlist=['FakeClient'])
        client = mod.FakeClient()
        for d in docs:
            client.create_resource('kyverno.io/v1', 'ClusterPolicy', '', d)
        for p in pods:
            client.create_resource('v1', 'Pod', p['metadata']['namespace'],
                                   p)
        clients[side] = client

    def strip(reports):
        out = []
        for r in reports:
            r = copy.deepcopy(r)
            meta = r['metadata']
            for k in ('resourceVersion', 'uid', 'creationTimestamp'):
                meta.pop(k, None)
            meta.get('annotations', {}).pop(
                'audit.kyverno.io/last-scan-time', None)
            for res in r.get('results') or r.get('spec', {}).get(
                    'results', []):
                res.pop('timestamp', None)
            out.append(r)
        return out

    def state(side):
        c = clients[side]
        return (strip(c.list_resource('kyverno.io/v1alpha2',
                                      'BackgroundScanReport')),
                strip(c.list_resource('wgpolicyk8s.io/v1alpha2',
                                      'PolicyReport')))

    daemons = {}
    for side in ('port', 'jax'):
        monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / side))
        daemons[side] = _daemon(side, clients[side])
        daemons[side].tick()
    port, jax_ = state('port'), state('jax')
    assert len(port[0]) == 30 and port[1]
    assert port == jax_
    for side in ('port', 'jax'):
        c = clients[side]
        pol = c.get_resource('kyverno.io/v1', 'ClusterPolicy', '',
                             docs[1]['metadata']['name'])
        pol['spec']['rules'][0]['validate']['message'] += ' (edited)'
        c.update_resource('kyverno.io/v1', 'ClusterPolicy', '', pol)
        monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / side))
        daemons[side].tick()
    assert daemons['port'].scan_controller.rescan_stats == \
        daemons['jax'].scan_controller.rescan_stats
    assert daemons['port'].scan_controller.rescan_stats[
        'rows_scanned'] == 30
    assert state('port') == state('jax')


def test_daemon_scan_to_policy_report(telemetry_off):
    """``tests/test_daemons.py``'s reports-daemon case on the port."""
    from kyverno_tpu_torch.dclient.client import FakeClient
    from test_daemons import AUDIT_POLICY
    client = FakeClient()
    client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                           AUDIT_POLICY)
    client.create_resource('v1', 'Pod', 'default', {
        'apiVersion': 'v1', 'kind': 'Pod',
        'metadata': {'name': 'p1', 'namespace': 'default',
                     'uid': 'u-p1', 'labels': {}},
        'spec': {'containers': [{'name': 'c', 'image': 'x'}]}})
    _daemon('port', client).tick()
    prs = client.list_resource('wgpolicyk8s.io/v1alpha2', 'PolicyReport',
                               'default', None)
    assert prs and prs[0]['summary']['fail'] == 1


def test_daemon_raises_without_cuda(telemetry_off, monkeypatch):
    from kyverno_tpu_torch.dclient.client import FakeClient
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        _daemon('port', FakeClient(), device=None)


def test_daemon_forks_the_encoder_pool_where_it_builds_the_scanner(
        telemetry_off, monkeypatch):
    """The daemon starts its new scanner's encode workers in the tick
    that builds it, before the reconcile scans; the partitioned path
    starts none."""
    from kyverno_tpu_torch.compiler import scan
    from kyverno_tpu_torch.dclient.client import FakeClient
    started = []
    monkeypatch.setattr(scan._EncoderPool, 'start',
                        lambda self: started.append(self) or False)
    client = FakeClient()
    client.create_resource('kyverno.io/v1', 'ClusterPolicy', '', POLICY)
    daemon = _daemon('port', client)
    daemon.tick()
    assert started == [daemon.scan_controller.scanner._encoder_pool]
    monkeypatch.setenv('KTPU_PARTITIONS', '2')
    client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                           OTHER_POLICY)
    daemon.tick()
    assert daemon.scan_controller.scanner._pset is not None
    assert len(started) == 1


# ---------------------------------------------------------------------------
# tests/test_report_controllers.py on the port, against the JAX package


def _world(side):
    mod = __import__('kyverno_tpu_torch.dclient.client' if side == 'port'
                     else 'kyverno_tpu.dclient.client',
                     fromlist=['FakeClient'])
    client = mod.FakeClient()
    client.create_resource('kyverno.io/v1', 'ClusterPolicy', '', POLICY)
    client.create_resource('v1', 'Pod', 'default', pod('good', team='infra'))
    client.create_resource('v1', 'Pod', 'default', pod('bad'))
    return client


def _pipeline(side):
    """Metadata sync, the scan and aggregation over ``_world``."""
    pkg = 'kyverno_tpu_torch' if side == 'port' else 'kyverno_tpu'
    ctl = __import__(f'{pkg}.reports.controllers', fromlist=['x'])
    agg = __import__(f'{pkg}.reports.aggregate', fromlist=['x'])
    P = _policy_class(side)
    client = _world(side)
    cache = ctl.MetadataCache()
    resource_ctrl = ctl.ResourceController(client, cache)
    kwargs = {'device': 'cpu'} if side == 'port' else {}
    scan_ctrl = ctl.BackgroundScanController(client, [P(POLICY)],
                                             cache=cache, **kwargs)
    resource_ctrl.update_policies([P(POLICY)])
    for changed in resource_ctrl.sync():
        scan_ctrl.enqueue(changed)
    reports = scan_ctrl.reconcile(now=NOW)
    agg.AggregateController(client).reconcile()
    return client, reports


def test_scan_writes_reports_and_aggregates(jax_reference):
    from kyverno_tpu_torch.reports.controllers import \
        ANNOTATION_LAST_SCAN_TIME
    from kyverno_tpu_torch.reports.results import get_results
    client, reports = _pipeline('port')
    assert len(reports) == 2
    stored = client.list_resource('kyverno.io/v1alpha2',
                                  'BackgroundScanReport', 'default', None)
    assert len(stored) == 2
    for r in stored:
        assert ANNOTATION_LAST_SCAN_TIME in r['metadata']['annotations']
    results = {r['metadata']['ownerReferences'][0]['name']:
               get_results(r) for r in stored}
    assert results['good'][0]['result'] == 'pass'
    assert results['bad'][0]['result'] == 'fail'
    prs = client.list_resource('wgpolicyk8s.io/v1alpha2', 'PolicyReport',
                               'default', None)
    summary = prs[0].get('summary') or {}
    assert summary.get('pass') == 1 and summary.get('fail') == 1
    jclient, jreports = _pipeline('jax')
    for kind in (('kyverno.io/v1alpha2', 'BackgroundScanReport'),
                 ('wgpolicyk8s.io/v1alpha2', 'PolicyReport')):
        assert [{k: v for k, v in r.items() if k != 'metadata'}
                for r in client.list_resource(*kind)] == \
            [{k: v for k, v in r.items() if k != 'metadata'}
             for r in jclient.list_resource(*kind)]


def test_last_scan_time_resumability():
    from kyverno_tpu_torch.reports.controllers import \
        BackgroundScanController
    scan_ctrl = BackgroundScanController(_world('port'), [Policy(POLICY)],
                                         device='cpu')
    p = pod('good', team='infra')
    scan_ctrl.enqueue(p)
    assert len(scan_ctrl.reconcile()) == 1
    scan_ctrl.enqueue(p)
    assert scan_ctrl.reconcile() == []
    scan_ctrl.enqueue(pod('good'))
    assert len(scan_ctrl.reconcile()) == 1


def test_policy_change_invalidates_scans():
    scan_ctrl = _controller([POLICY], 'port')
    p = pod('good', team='infra')
    scan_ctrl.enqueue(p)
    scan_ctrl.reconcile()
    scan_ctrl.set_policies([Policy(POLICY)])
    scan_ctrl.enqueue(p)
    assert len(scan_ctrl.reconcile()) == 1


def test_admission_reports_merge_by_uid():
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.reports.controllers import \
        AdmissionReportController
    from kyverno_tpu_torch.reports.results import get_results
    client = FakeClient()
    for i in range(3):
        client.create_resource('kyverno.io/v1alpha2', 'AdmissionReport',
                               'default', {
            'apiVersion': 'kyverno.io/v1alpha2', 'kind': 'AdmissionReport',
            'metadata': {
                'name': f'rep-{i}', 'namespace': 'default',
                'creationTimestamp': f'2026-01-0{i + 1}T00:00:00Z',
                'labels': {'audit.kyverno.io/resource.uid': 'u1'}},
            'spec': {'results': [{'policy': 'p', 'rule': f'r{i}',
                                  'result': 'pass', 'source': 'kyverno'}]},
        })
    assert AdmissionReportController(client).reconcile() == 1
    left = client.list_resource('kyverno.io/v1alpha2', 'AdmissionReport',
                                'default', None)
    assert len(left) == 1
    assert len(get_results(left[0])) == 3
    assert left[0]['spec']['summary']['pass'] == 3


# ---------------------------------------------------------------------------
# tests/test_report_fusion.py on the port


def test_fused_reports_match_unfused_and_are_sorted():
    """The controller's fused report path (``scan_report_results`` →
    ``build_fused_report``) against the unfused one (``scan_stream`` →
    ``set_responses``) on the port's scanner, over the fusion test's
    pack: equal labels, summaries and results (timestamps aside), each
    row's results sorted."""
    import bench
    import test_report_fusion
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.reports.results import (set_fused_results,
                                                   set_responses)
    from kyverno_tpu_torch.reports.types import new_background_scan_report
    scanner = BatchScanner(load_policies_from_yaml(test_report_fusion.PACK),
                           device='cpu')
    rng = random.Random(3)
    pods = [bench.make_pod(rng, i) for i in range(96)]
    strip = test_report_fusion._strip_ts
    for p, responses, (results, summary, policies) in zip(
            pods, scanner.scan_stream(pods),
            scanner.scan_report_results(pods)):
        unfused = new_background_scan_report(p)
        set_responses(unfused,
                      *[r for r in responses if r.policy_response.rules])
        fused = new_background_scan_report(p)
        set_fused_results(fused, results, summary, policies)
        assert fused['metadata'].get('labels') == \
            unfused['metadata'].get('labels')
        assert fused['spec']['summary'] == unfused['spec']['summary']
        assert strip(fused['spec']['results']) == \
            strip(unfused['spec']['results'])
        keys = [(r.get('policy', ''), r.get('rule', '')) for r in results]
        assert keys == sorted(keys)
