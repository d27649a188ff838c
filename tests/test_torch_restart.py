"""Daemons of the port restarted on the state they left, on the CPU: the
policy-set fingerprint digests only what the engine reads of a policy
(not its status nor the API server's stamps), so a restarted admission
daemon loads its K1v program and a restarted reports daemon replays its
verdict rows after the reconciler wrote status; and the reports carry
each policy's current resourceVersion, as the JAX daemons' do.  Then
every daemon of the port and of the JAX package over HTTP, each against
a ``FakeApiServer`` of its own package with the kinds of
``chip_smoke.API_KINDS`` registered.
"""

import contextlib
import copy
import time

import pytest

import chip_smoke
from test_torch_aot_cache import _evaluator_and_batch, _smoke_inputs
from test_torch_daemons import CASES, _cluster, _Daemons, _stop, _strip
from test_torch_report_controllers import _smoke, telemetry_off  # noqa: F401
from test_torch_reference import jax_reference  # noqa: F401
from kyverno_tpu_torch.aotcache.keys import (policy_semantics,
                                             policy_set_fingerprint)
from kyverno_tpu_torch.api.policy import Policy

STAMPS = {'resourceVersion': '42', 'generation': 3, 'uid': 'uid-42',
          'creationTimestamp': '2026-01-02T03:04:05Z',
          'managedFields': [{'manager': 'kyverno', 'operation': 'Update'}],
          'selfLink': '/apis/kyverno.io/v1/clusterpolicies/p'}
STATUS = {'ready': True, 'conditions': [{'type': 'Ready',
                                         'status': 'True'}]}
KEPT = {'apiVersion': ('top', 'kyverno.io/v2beta1'),
        'kind': ('top', 'Policy'),
        'namespace': ('metadata', 'team-a'),
        'name': ('metadata', 'renamed'),
        'labels': ('metadata', {'tier': 'gold'}),
        'annotations': ('metadata', {'policies.kyverno.io/title': 'x'}),
        'spec': ('top', {'rules': []})}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Stores of the test's own (the defaults are the repository's
    ``.cache/``), no encoder fork, the whole policy set."""
    from kyverno_tpu_torch.aotcache import reset_default_store
    from kyverno_tpu_torch.compiler import aot
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    monkeypatch.setenv('KTPU_PARTITIONS', '0')
    reset_default_store()
    yield
    aot.flush_stores()
    reset_default_store()


def _doc():
    return copy.deepcopy(_smoke_inputs()[0][0].raw)


def _fingerprint(doc):
    return policy_set_fingerprint([Policy(doc)])


@pytest.mark.parametrize('field', sorted(STAMPS) + ['status'])
def test_fingerprint_ignores_status_and_server_stamps(field):
    doc = _doc()
    stamped = copy.deepcopy(doc)
    if field == 'status':
        stamped['status'] = STATUS
    else:
        stamped['metadata'][field] = STAMPS[field]
    assert policy_semantics(stamped) == policy_semantics(doc)
    assert _fingerprint(stamped) == _fingerprint(doc)


@pytest.mark.parametrize('field', sorted(KEPT))
def test_fingerprint_follows_what_the_engine_reads(field):
    doc = _doc()
    where, value = KEPT[field]
    changed = copy.deepcopy(doc)
    (changed if where == 'top' else changed['metadata'])[field] = value
    assert _fingerprint(changed) != _fingerprint(doc)


def _stamped(policies):
    out = []
    for i, p in enumerate(policies):
        doc = copy.deepcopy(p.raw)
        doc['metadata'].update(STAMPS, resourceVersion=str(100 + i))
        doc['status'] = STATUS
        out.append(Policy(doc))
    return out


def test_stamped_sets_lower_to_byte_equal_programs(monkeypatch):
    """A policy set and the same set with status and stamps: lowered
    apart they give byte-equal K1v programs, and with the store on the
    second finds the first one's program under the same key."""
    from kyverno_tpu_torch.compiler import aot
    tpols, docs = _smoke_inputs()
    monkeypatch.setenv('KTPU_AOT', '0')
    blobs = []
    for pols in (tpols, _stamped(tpols)):
        ev, _packed, layout = _evaluator_and_batch(pols, docs)
        blobs.append(aot.encode_executable(ev.plan_for(layout).program))
    assert blobs[0] == blobs[1]
    monkeypatch.setenv('KTPU_AOT', '1')
    plans = []
    for pols in (tpols, _stamped(tpols)):
        ev, packed, layout = _evaluator_and_batch(pols, docs)
        plans.append(ev.plan_for(layout, packed))
    assert [p.source for p in plans] == ['fresh_compile', 'aot_load']
    assert plans[0].aot_key == plans[1].aot_key
    assert aot.encode_executable(plans[1].program) == blobs[0]


# ---------------------------------------------------------------------------
# transports


@contextlib.contextmanager
def _served(store, package='kyverno_tpu_torch'):
    """A ``FakeApiServer`` of ``package`` over ``store`` with every kind
    of ``chip_smoke.API_KINDS``; yields a factory of HTTP clients to it,
    which it closes afterwards."""
    import importlib
    server = importlib.import_module(f'{package}.dclient.fakeserver')
    http = importlib.import_module(f'{package}.dclient.http_client')
    srv = server.FakeApiServer(store)
    chip_smoke.register_kinds(srv)
    clients = []

    def client():
        clients.append(http.HTTPClient(http.ClusterConfig(server=srv.url)))
        return clients[-1]

    with srv:
        try:
            yield client
        finally:
            for c in clients:
                c.close()


@contextlib.contextmanager
def _transport(kind, store):
    if kind == 'fake':
        yield lambda: store
        return
    with _served(store) as client:
        yield client


def _enforce_plans(daemon):
    from kyverno_tpu_torch.policycache import cache as pcache
    enforce = daemon.cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod',
                                        'default')
    scanner = daemon.handlers._device_scanner(enforce)
    return sorted(p.source for p in scanner._evaluator.plans.values()
                  if p.program is not None)


@pytest.mark.parametrize('transport', ['fake', 'http'])
def test_restarted_admission_daemon_loads_its_program(transport, monkeypatch,
                                                      telemetry_off):
    """A second admission daemon on the same cluster, after the first
    one's reconciler wrote every policy's status, loads the K1v program
    the first one lowered and stored, and lowers none."""
    from kyverno_tpu_torch.cmd.admission_controller import \
        AdmissionController
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.compiler import aot
    from kyverno_tpu_torch.dclient.client import FakeClient
    monkeypatch.setenv('KTPU_AOT', '1')
    store = _cluster(FakeClient)
    sources, fingerprints = [], []
    with _transport(transport, store) as client:
        for _ in range(2):
            setup = Setup('t', ['--disable-metrics'], client=client())
            daemon = AdmissionController(setup, tls=False, device='cpu')
            try:
                daemon.tick()
                assert daemon.warmer.wait(120)
                assert daemon.warmer.detail.startswith(
                    'compiled scanner serving')
                sources.append(_enforce_plans(daemon))
                fingerprints.append(policy_set_fingerprint(
                    daemon.sync_policies()))
            finally:
                _stop(daemon, setup)
                aot.flush_stores()
            docs = store.list_resource('kyverno.io/v1', 'ClusterPolicy',
                                       '', None)
            assert docs and all(d.get('status') for d in docs)
    assert sources[0] and set(sources[0]) == {'fresh_compile'}
    assert sources[1] == ['aot_load'] * len(sources[0])
    assert fingerprints[0] == fingerprints[1]


def test_admission_report_labels_follow_the_server():
    """The port's daemon keeps its Policy objects across status writes
    (no scanner rebuild), and its admission reports still carry each
    policy's current resourceVersion: after three ticks, equal to the
    JAX daemon's, labels included."""
    d = _Daemons()
    try:
        scanner = d.port.handlers._device_scanner(
            d.port.cache.get_policies('ValidateEnforce', 'Pod', 'default'))
        for _ in range(2):
            d.jax.tick()
            d.port.tick()
        for i in range(2):
            d.serve(f'validate-compliant-{i}')
        d.jax.flush_audits()
        d.port.flush_audits()
        reports = [sorted((_strip(r) for r in client.list_resource(
            'kyverno.io/v1alpha2', 'AdmissionReport', '', None)),
            key=lambda r: r['metadata']['name'])
            for client in (d.jclient, d.tclient)]
        assert len(reports[1]) == 2 and reports[1] == reports[0]
        current = chip_smoke.current_resource_versions(d.tclient)
        assert chip_smoke.stale_policy_labels(reports[1], current) == []
        labels = reports[1][0]['metadata']['labels']
        assert sum(k.startswith('cpol.kyverno.io/') for k in labels) >= 12
        # the status writes bumped every resourceVersion past the first
        # sync's, and the port built no new scanner for them
        assert d.port.handlers._device_scanner(
            d.port.cache.get_policies('ValidateEnforce', 'Pod',
                                      'default')) is scanner
    finally:
        d.close()


def _reports_state(client):
    def strip(reports):
        out = []
        for r in sorted(reports, key=lambda r: (
                r['metadata'].get('namespace', ''), r['metadata']['name'])):
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
    return (strip(client.list_resource('kyverno.io/v1alpha2',
                                       'BackgroundScanReport')),
            strip(client.list_resource('wgpolicyk8s.io/v1alpha2',
                                       'PolicyReport')))


def _write_status(package, client):
    """What the admission daemon's reconciler writes: each
    ClusterPolicy's status."""
    import importlib
    webhook = importlib.import_module(f'{package}.controllers.webhook')
    policy = importlib.import_module(f'{package}.api.policy')
    docs = client.list_resource('kyverno.io/v1', 'ClusterPolicy', '', None)
    webhook.WebhookConfigReconciler(client, b'', 'kyverno').reconcile(
        [policy.Policy(d) for d in docs])
    after = client.list_resource('kyverno.io/v1', 'ClusterPolicy', '', None)
    assert all(a.get('status') for a in after)
    assert [a['metadata']['resourceVersion'] for a in after] != \
        [d['metadata']['resourceVersion'] for d in docs]


def test_restarted_reports_daemon_replays_after_a_status_write(
        jax_reference, telemetry_off, monkeypatch, tmp_path):
    """Each package's reports daemon ticks, the reconciler writes every
    policy's status, and a new daemon ticks on the same cluster.  The
    port's restarted daemon replays every row from the verdict cache
    under the same generation (the JAX one rescans: its key digests the
    status), and both write the same reports and PolicyReports, the
    labels of each policy's current resourceVersion included."""
    from test_torch_report_controllers import _daemon
    docs, pods = _smoke(30)
    clients = {}
    for side, package in (('port', 'kyverno_tpu_torch'),
                          ('jax', 'kyverno_tpu')):
        import importlib
        client = importlib.import_module(
            f'{package}.dclient.client').FakeClient()
        for d in docs:
            client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                                   copy.deepcopy(d))
        for p in pods:
            client.create_resource('v1', 'Pod', p['metadata']['namespace'],
                                   copy.deepcopy(p))
        clients[side] = client
    stats, generations = {}, {}
    for side, package in (('port', 'kyverno_tpu_torch'),
                          ('jax', 'kyverno_tpu')):
        monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / side))
        first = _daemon(side, clients[side])
        first.tick()
        first.setup.shutdown()
        _write_status(package, clients[side])
        second = _daemon(side, clients[side])
        second.tick()
        stats[side] = dict(second.scan_controller.rescan_stats)
        generations[side] = (first.scan_controller.verdict_cache.fingerprint,
                             second.scan_controller.verdict_cache.fingerprint)
        second.setup.shutdown()
    assert stats['port'] == {'rows_pending': 30, 'rows_scanned': 0,
                             'rows_replayed': 30}
    assert generations['port'][0] == generations['port'][1]
    assert stats['jax']['rows_scanned'] == 30
    port, jax_ = _reports_state(clients['port']), \
        _reports_state(clients['jax'])
    assert len(port[0]) == 30 and port[1]
    assert port == jax_
    current = chip_smoke.current_resource_versions(clients['port'])
    assert chip_smoke.stale_policy_labels(port[0] + port[1], current) == []


# ---------------------------------------------------------------------------
# every daemon over HTTP


def test_register_kinds_gives_each_kind_its_scope():
    from kyverno_tpu_torch.dclient.fakeserver import FakeApiServer
    seeded = len(FakeApiServer().registry.by_plural)
    srv = FakeApiServer()
    chip_smoke.register_kinds(srv)
    by_kind = {(av, kind): ns for (av, _plural), (kind, ns)
               in srv.registry.by_plural.items()}
    # none of them was seeded, and each keeps its own entry
    assert seeded == 10
    assert len(by_kind) == seeded + len(chip_smoke.API_KINDS)
    for av, kind, _plural, namespaced in chip_smoke.API_KINDS:
        assert by_kind[(av, kind)] is namespaced
    assert by_kind[('kyverno.io/v1alpha2', 'AdmissionReport')] is True
    assert by_kind[('wgpolicyk8s.io/v1alpha2',
                    'ClusterPolicyReport')] is False


def test_admission_and_background_daemons_over_http(telemetry_off):
    """The admission daemon and the background controller of each
    package, each package against a server of its own over HTTP: the
    same responses, webhook configurations (but for the CA), policy
    status, UpdateRequests and generated NetworkPolicies."""
    import importlib
    out = {}
    for package in ('kyverno_tpu', 'kyverno_tpu_torch'):
        fake = importlib.import_module(f'{package}.dclient.client')
        internal = importlib.import_module(f'{package}.cmd.internal')
        adm = importlib.import_module(f'{package}.cmd.admission_controller')
        bg = importlib.import_module(f'{package}.cmd.background_controller')
        store = _cluster(fake.FakeClient)
        with _served(store, package) as client:
            setup = internal.Setup('t', ['--disable-metrics'],
                                   client=client())
            kwargs = {'device': 'cpu'} if package.endswith('torch') else {}
            daemon = adm.AdmissionController(setup, tls=False, **kwargs)
            if not kwargs:
                daemon.handlers.device = False
            try:
                daemon.tick()
                if kwargs:
                    enforce = daemon.cache.get_policies(
                        'ValidateEnforce', 'Pod', 'default')
                    assert daemon.handlers.wait_device_ready(enforce,
                                                             timeout=120)
                answers = {name: daemon.server.handle(*CASES[name])
                           for name in sorted(CASES)}
                store.create_resource('v1', 'Namespace', '', {
                    'apiVersion': 'v1', 'kind': 'Namespace',
                    'metadata': {'name': 'team-a'}})
                bg.BackgroundController(internal.Setup(
                    'bg', ['--disable-metrics'], client=client())).tick()
            finally:
                _stop(daemon, setup)
        state = {}
        for api, kind, ns in (
                ('admissionregistration.k8s.io/v1',
                 'ValidatingWebhookConfiguration', ''),
                ('admissionregistration.k8s.io/v1',
                 'MutatingWebhookConfiguration', ''),
                ('kyverno.io/v1', 'ClusterPolicy', ''),
                ('kyverno.io/v1beta1', 'UpdateRequest', 'kyverno'),
                ('networking.k8s.io/v1', 'NetworkPolicy', 'team-a')):
            objs = [_strip(o) for o in store.list_resource(api, kind, ns,
                                                          None)]
            for o in objs:
                for w in o.get('webhooks') or []:
                    w['clientConfig'].pop('caBundle', None)
                (o['metadata'].get('labels') or {}).pop(
                    'policy.kyverno.io/gr-name', None)
                o['metadata'].pop('name', None) \
                    if kind == 'UpdateRequest' else None
            state[kind] = objs
        out[package] = (answers, state)
    want, got = out['kyverno_tpu'], out['kyverno_tpu_torch']
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[1]['NetworkPolicy']) == 1
    assert all(p.get('status') for p in got[1]['ClusterPolicy'])


def test_reports_daemon_over_http(jax_reference, telemetry_off, monkeypatch,
                                  tmp_path):
    """The port's reports daemon over HTTP writes what the JAX package's
    writes over its in-memory client; the JAX daemon over HTTP lists no
    Pod (its client writes ``/api//pods`` for a kind-only list) and
    writes no report."""
    from kyverno_tpu.dclient.client import FakeClient as JaxClient
    from kyverno_tpu_torch.dclient.client import FakeClient
    from test_torch_report_controllers import _daemon
    docs, pods = _smoke(20)
    stores = {}
    for side, cls in (('port', FakeClient), ('jax', JaxClient),
                      ('jax-http', JaxClient)):
        store = cls()
        for d in docs:
            store.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                                  copy.deepcopy(d))
        for p in pods:
            store.create_resource('v1', 'Pod', p['metadata']['namespace'],
                                  copy.deepcopy(p))
        stores[side] = store
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'port'))
    with _served(stores['port']) as client:
        daemon = _daemon('port', client())
        daemon.tick()
        daemon.setup.shutdown()
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'jax'))
    daemon = _daemon('jax', stores['jax'])
    daemon.tick()
    daemon.setup.shutdown()
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'jax-http'))
    with _served(stores['jax-http'], 'kyverno_tpu') as client:
        daemon = _daemon('jax', client())
        daemon.tick()
        daemon.setup.shutdown()
    port = _reports_state(stores['port'])
    assert len(port[0]) == 20 and port[1]
    assert port == _reports_state(stores['jax'])
    assert _reports_state(stores['jax-http']) == ([], [])


@pytest.mark.parametrize('package', ['kyverno_tpu', 'kyverno_tpu_torch'])
def test_kind_less_watches_deliver_nothing_over_http(package):
    """``config.py`` and ``policymetrics.py`` watch without a kind.  Over
    HTTP that watch asks for ``/api/v1/s``, which the server answers 404,
    and the client retries each second without a word: in both packages
    the callback never runs."""
    import importlib
    fake = importlib.import_module(f'{package}.dclient.client')
    server = importlib.import_module(f'{package}.dclient.fakeserver')
    http = importlib.import_module(f'{package}.dclient.http_client')
    srv = server.FakeApiServer(fake.FakeClient())
    counter = chip_smoke.RequestCounter(srv)
    with srv:
        client = http.HTTPClient(http.ClusterConfig(server=srv.url))
        got = []
        client.watch(lambda ev, obj: got.append(ev))
        time.sleep(0.3)
        client.create_resource('v1', 'ConfigMap', 'kyverno', {
            'apiVersion': 'v1', 'kind': 'ConfigMap',
            'metadata': {'name': 'kyverno', 'namespace': 'kyverno'}})
        deadline = time.monotonic() + 5
        while counter.snapshot().get('watch ?', 0) < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        client.close()
    assert got == []
    assert counter.snapshot().get('watch ?', 0) >= 2
