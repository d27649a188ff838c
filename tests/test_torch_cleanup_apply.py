"""The host-only daemons and tools of the port against the JAX package's
on the same inputs: the cleanup controller and its daemon
(``controllers/cleanup.py``, ``cmd/cleanup_controller.py``) on the cases
of ``tests/test_daemons.py``, ``tests/test_cleanup_oci_metrics.py`` and
``tests/test_auth.py`` and over HTTP; the install-time manifests
(``config/install.py``); the chart renderer (``utils/helmlite.py``) on a
chart this file writes; and the bulk applier (``compiler/apply.py``) on
the BASELINE config-5 cases of ``tests/test_baseline_configs.py`` and
``tests/test_mutate_compile.py``, serial and on a process pool, byte-equal
to the JAX ``BatchApplier`` and to the engine loop.
"""

import copy
import importlib
import json
import random
import urllib.error
import urllib.request

import pytest
import torch

import bench
import test_auth
from test_cleanup_oci_metrics import CLEANUP_POLICY as CRON_POLICY
from test_daemons import CLEANUP_POLICY

PACKAGES = ('kyverno_tpu', 'kyverno_tpu_torch')


def _mod(package, name):
    return importlib.import_module(f'{package}.{name}')


def _configmaps(client):
    return [c['metadata']['name'] for c in client.list_resource(
        'v1', 'ConfigMap', 'default', None)]


def _cleanup_store(package):
    client = _mod(package, 'dclient.client').FakeClient()
    client.create_resource('kyverno.io/v2alpha1', 'ClusterCleanupPolicy', '',
                           copy.deepcopy(CLEANUP_POLICY))
    for name, labels in (('tmp', {'temp': 'true'}), ('keep', None)):
        meta = {'name': name, 'namespace': 'default'}
        if labels:
            meta['labels'] = labels
        client.create_resource('v1', 'ConfigMap', 'default', {
            'apiVersion': 'v1', 'kind': 'ConfigMap', 'metadata': meta})
    return client


def _setup(package, client):
    internal = _mod(package, 'cmd.internal')
    return internal.Setup('test', [], internal.base_parser('test'),
                          client=client)


# ---------------------------------------------------------------------------
# cleanup: each case returns what it observed, in each package


def case_daemon_deletes_matching(package):
    """TestCleanupDaemon.test_cleanup_deletes_matching"""
    client = _cleanup_store(package)
    _mod(package, 'cmd.cleanup_controller').CleanupDaemon(
        _setup(package, client)).tick()
    return _configmaps(client)


def _cronjob(cj):
    cj = copy.deepcopy(cj)
    for k in ('uid', 'resourceVersion', 'creationTimestamp'):
        cj['metadata'].pop(k, None)
    return cj


def case_cronjob_reconciled(package):
    """TestCleanupCronJobs.test_cronjob_reconciled"""
    client = _mod(package, 'dclient.client').FakeClient()
    ctrl = _mod(package, 'controllers.cleanup').CleanupController(client)
    ctrl.set_policy(copy.deepcopy(CRON_POLICY))
    made = ctrl.reconcile_cronjobs('kyverno')
    stored = client.list_resource('batch/v1', 'CronJob', 'kyverno', None)
    return [_cronjob(c) for c in made], [_cronjob(c) for c in stored]


def case_stale_cronjob_removed(package):
    """TestCleanupCronJobs.test_stale_cronjob_removed"""
    client = _mod(package, 'dclient.client').FakeClient()
    ctrl = _mod(package, 'controllers.cleanup').CleanupController(client)
    ctrl.set_policy(copy.deepcopy(CRON_POLICY))
    first = len(ctrl.reconcile_cronjobs('kyverno'))
    ctrl.delete_policy(copy.deepcopy(CRON_POLICY))
    ctrl.reconcile_cronjobs('kyverno')
    return first, client.list_resource('batch/v1', 'CronJob', 'kyverno',
                                       None)


def case_cleanup_http_endpoint(package):
    """TestCleanupCronJobs.test_cleanup_http_endpoint"""
    client = _mod(package, 'dclient.client').FakeClient()
    client.create_resource('kyverno.io/v2alpha1', 'ClusterCleanupPolicy', '',
                           copy.deepcopy(CRON_POLICY))
    client.create_resource('v1', 'ConfigMap', 'default', {
        'apiVersion': 'v1', 'kind': 'ConfigMap',
        'metadata': {'name': 'tmp', 'namespace': 'default',
                     'labels': {'temp': 'true'}}})
    internal = _mod(package, 'cmd.internal')
    setup = internal.Setup('cleanup', args=[])
    setup.client = client
    daemon = _mod(package, 'cmd.cleanup_controller').CleanupDaemon(setup)
    daemon.sync_policies()
    port = daemon.server.start()
    try:
        body = urllib.request.urlopen(
            f'http://127.0.0.1:{port}/cleanup?policy=sweep-temps'
        ).read().decode()
        left = _configmaps(client)
        try:
            urllib.request.urlopen(
                f'http://127.0.0.1:{port}/cleanup?policy=nope')
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
    finally:
        daemon.server.stop()
    return body, left, code


def _auth(package, verbs):
    client = _mod(package, 'dclient.client').FakeClient()
    if verbs:
        client.access_review_hook = test_auth.deny(*verbs)
    return _mod(package, 'controllers.cleanup').validate_cleanup_policy_auth(
        copy.deepcopy(test_auth.TestCleanupAuth.DOC), client)


def case_auth_allowed(package):
    """TestCleanupAuth.test_allowed"""
    return _auth(package, ())


def case_auth_denied_delete(package):
    """TestCleanupAuth.test_denied_delete"""
    return _auth(package, ('delete',))


def case_auth_denied_list(package):
    """TestCleanupAuth.test_denied_list"""
    return _auth(package, ('list',))


def case_cleanup_validate_route(package):
    """TestCleanupAuth.test_cleanup_validate_route"""
    client = _mod(package, 'dclient.client').FakeClient()
    client.access_review_hook = test_auth.deny('delete')
    server = _mod(package, 'cmd.cleanup_controller').CleanupHTTPServer(
        _mod(package, 'controllers.cleanup').CleanupController(client),
        host='127.0.0.1')
    port = server.start()
    out = []
    try:
        review = {'request': {'uid': 'u1',
                              'object': test_auth.TestCleanupAuth.DOC}}
        for hook in (test_auth.deny('delete'), None):
            client.access_review_hook = hook
            out.append(json.load(urllib.request.urlopen(
                urllib.request.Request(
                    f'http://127.0.0.1:{port}/validate',
                    json.dumps(review).encode(),
                    {'Content-Type': 'application/json'}))))
    finally:
        server.stop()
    return out


CLEANUP_CASES = {name[len('case_'):]: fn for name, fn in sorted(
    globals().items()) if name.startswith('case_')}


@pytest.mark.parametrize('name', sorted(CLEANUP_CASES))
def test_cleanup_case_equals_the_jax_package(name):
    want, got = (CLEANUP_CASES[name](p) for p in PACKAGES)
    assert got == want
    if name == 'daemon_deletes_matching':
        assert got == ['keep']
    if name == 'cleanup_validate_route':
        assert [r['response']['allowed'] for r in got] == [False, True]


def test_cleanup_daemon_over_http():
    """The port's cleanup daemon over HTTP deletes what the JAX
    package's deletes over its in-memory client; the JAX daemon over
    HTTP lists ConfigMaps by kind alone (``/api//configmaps``, a 404)
    and deletes nothing."""
    import chip_smoke
    left = {}
    for package, over_http in (('kyverno_tpu', False),
                               ('kyverno_tpu_torch', True),
                               ('kyverno_tpu', True)):
        store = _cleanup_store(package)
        if not over_http:
            _mod(package, 'cmd.cleanup_controller').CleanupDaemon(
                _setup(package, store)).tick()
            left[(package, over_http)] = _configmaps(store)
            continue
        srv = _mod(package, 'dclient.fakeserver').FakeApiServer(store)
        chip_smoke.register_kinds(srv)
        http = _mod(package, 'dclient.http_client')
        with srv:
            client = http.HTTPClient(http.ClusterConfig(server=srv.url))
            _mod(package, 'cmd.cleanup_controller').CleanupDaemon(
                _setup(package, client)).tick()
            client.close()
        left[(package, over_http)] = _configmaps(store)
        cronjobs = store.list_resource('batch/v1', 'CronJob', 'kyverno',
                                       None)
        assert len(cronjobs) == 1
    assert left[('kyverno_tpu_torch', True)] == \
        left[('kyverno_tpu', False)] == ['keep']
    assert left[('kyverno_tpu', True)] == ['keep', 'tmp']


# ---------------------------------------------------------------------------
# install manifests and the chart renderer


def test_install_manifests_equal_the_jax_package():
    out = []
    for package in PACKAGES:
        install = _mod(package, 'config.install')
        client = _mod(package, 'dclient.client').FakeClient()
        install.seed_install_manifests(client)
        install.seed_install_manifests(client)   # idempotent
        out.append((install.install_cluster_roles(), client.list_resource(
            'rbac.authorization.k8s.io/v1', 'ClusterRole', '', None)))
    assert out[1] == out[0]
    assert len(out[1][1]) == 4


TEMPLATE = '''\
{{- $name := "disallow-host-ports" }}
{{- if eq (include "kyverno-policies.podSecurityBaseline" (merge (dict "name" $name) .)) "true" }}
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: {{ $name }}
  annotations:
    policies.kyverno.io/title: Disallow hostPorts
spec:
  validationFailureAction: {{ .Values.validationFailureAction }}
  {{- with index .Values "validationFailureActionByPolicy" $name }}
  validationFailureActionOverrides: overridden
  {{- end }}
  background: {{ .Values.background }}
  failurePolicy: {{ .Values.failurePolicy }}
  rules:
    - name: host-ports-none
      match:
        any:
        - resources:
            kinds:
              - Pod
      {{- if .Values.policyExclude }}
      exclude: {}
      {{- else }}
      preconditions: {}
      {{- end }}
      validate:
        message: >-
          Use of host ports is disallowed in {{`{{ request.object.metadata.name }}`}}.
        pattern:
          spec:
            =(containers):
              - =(ports):
                  - =(hostPort): 0
{{- end }}
'''


@pytest.mark.parametrize('values', [None, {
    'validationFailureAction': 'Enforce', 'background': False,
    'policyExclude': {'any': []},
    'validationFailureActionByPolicy': {'disallow-host-ports': 'Audit'}}])
def test_helmlite_renders_like_the_jax_package(tmp_path, values):
    for profile in ('baseline', 'restricted'):
        (tmp_path / 'templates' / profile).mkdir(parents=True)
        (tmp_path / 'templates' / profile /
         'disallow-host-ports.yaml').write_text(TEMPLATE)
    out = []
    for package in PACKAGES:
        helm = _mod(package, 'utils.helmlite')
        out.append((helm.render(TEMPLATE, 'disallow-host-ports', values),
                    helm.render(TEMPLATE, 'disallow-host-ports', values,
                                restricted=True),
                    helm.load_chart_policies(str(tmp_path),
                                             ('baseline', 'restricted'),
                                             values)))
    assert out[1] == out[0]
    docs = out[1][2]
    assert len(docs) == 2 and docs[0]['metadata']['name'] == \
        'disallow-host-ports'
    assert '{{ request.object.metadata.name }}' in \
        docs[0]['spec']['rules'][0]['validate']['message']


# ---------------------------------------------------------------------------
# the bulk applier (BASELINE config 5)


def _policies(package):
    return _mod(package, 'api.policy').load_policies_from_yaml(
        bench.CONFIG5_PACK)


def _dump(n, seed=11):
    rng = random.Random(seed)
    return [bench.make_config5_resource(rng, i) for i in range(n)]


def _results(results):
    """The results as JSON, keys in the order the applier wrote them."""
    return json.dumps([(r.patched, r.rule_results, r.ur_specs)
                       for r in results]).encode()


def _apply(package, docs, processes, parallel, monkeypatch=None,
           fast=True):
    if monkeypatch is not None:
        monkeypatch.setenv('KTPU_FAST_MUTATE', '1' if fast else '0')
    applier = _mod(package, 'compiler.apply').BatchApplier(
        _policies(package), processes=processes)
    try:
        return applier, applier.apply(docs, parallel=parallel)
    finally:
        if getattr(applier, '_pool', None) is not None:
            applier._pool.shutdown()


def _engine_loop(policies, docs):
    """The serial engine loop of ``test_applier_matches_engine_loop``:
    each mutate policy in turn on the resource the last one patched."""
    from kyverno_tpu_torch.engine.api import PolicyContext
    from kyverno_tpu_torch.engine.engine import Engine
    engine = Engine()
    out = []
    for doc in docs:
        patched = doc
        for policy in policies:
            resp = engine.mutate(PolicyContext(policy, new_resource=patched))
            if resp.patched_resource is not None:
                patched = resp.patched_resource
        out.append(patched)
    return out


@pytest.mark.parametrize('processes', [1, 2])
def test_applier_equals_the_jax_applier_and_the_engine_loop(processes):
    """test_applier_matches_engine_loop and test_parallel_matches_serial:
    the port's results are byte-equal to the JAX applier's, serial and
    on the pool, and the patched resources to the engine loop's."""
    docs = _dump(300)
    jax_applier, want = _apply('kyverno_tpu', docs, 0, False)
    applier, serial = _apply('kyverno_tpu_torch', docs, processes, False)
    assert _results(serial) == _results(want)
    _applier, par = _apply('kyverno_tpu_torch', docs, processes, True)
    assert _results(par) == _results(want)
    if processes > 1:
        assert _applier._pool is not None, 'the pool fell back in-process'
    assert [r.patched for r in serial] == _engine_loop(
        applier.mutate_policies, docs)


def test_applier_mutations_and_pull_policy():
    """test_mutations_applied and test_foreach_preserves_existing_pull_
    policy on the port."""
    docs = _dump(300)
    _a, results = _apply('kyverno_tpu_torch', docs, 0, None)
    pods = [(d, r) for d, r in zip(docs, results) if d.get('kind') == 'Pod']
    assert pods
    for _doc, r in pods:
        assert r.patched['metadata']['labels'].get('managed') == 'true'
        assert r.patched['metadata']['annotations'].get(
            'policy.io/revision') == 'r1'
    doc = {'apiVersion': 'v1', 'kind': 'Pod',
           'metadata': {'name': 'p', 'namespace': 'default'},
           'spec': {'containers': [
               {'name': 'a', 'image': 'nginx:1', 'imagePullPolicy': 'Always'},
               {'name': 'b', 'image': 'redis:7'}]}}
    [r] = _apply('kyverno_tpu_torch', [doc], 0, None)[1]
    conts = {c['name']: c for c in r.patched['spec']['containers']}
    assert conts['a']['imagePullPolicy'] == 'Always'
    assert conts['b']['imagePullPolicy'] == 'IfNotPresent'


def test_applier_generate_specs_feed_the_background_pipeline():
    """test_generate_urs_feed_background_pipeline on the port: one
    UpdateRequest spec per Namespace, equal to the JAX applier's, and
    the port's background controller generates one NetworkPolicy
    each."""
    from kyverno_tpu_torch.background.update_request_controller import \
        UpdateRequestController
    from kyverno_tpu_torch.background.updaterequest import \
        UpdateRequestGenerator
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.engine.engine import Engine
    docs = _dump(300)
    _j, want = _apply('kyverno_tpu', docs, 0, None)
    applier, results = _apply('kyverno_tpu_torch', docs, 0, None)
    specs = [s for r in results for s in r.ur_specs]
    assert specs == [s for r in want for s in r.ur_specs]
    namespaces = [d for d in docs if d.get('kind') == 'Namespace']
    assert len(specs) == len(namespaces) > 0
    client = FakeClient()
    for ns in namespaces:
        client.create_resource('v1', 'Namespace', '', ns)
    by_name = {p.name: p for p in applier.policies}
    ctrl = UpdateRequestController(client, Engine(),
                                   policy_getter=by_name.get)
    gen = UpdateRequestGenerator(client)
    for spec in specs:
        gen.apply(spec)
    ctrl.process_pending()
    netpols = client.list_resource('networking.k8s.io/v1', 'NetworkPolicy')
    assert len(netpols) == len(namespaces)


@pytest.mark.parametrize('fast', [True, False])
def test_fast_and_engine_paths_equal_the_jax_applier(fast, monkeypatch):
    """test_config5_pack_compiles_fast and test_fast_matches_engine_bit_
    identical: the precompiled path and the engine path, each byte-equal
    to the JAX applier's on the shape escapes too."""
    docs = _dump(400, seed=23)
    docs.append({'apiVersion': 'v1', 'kind': 'Pod',
                 'metadata': {'name': 'weird', 'namespace': 'x',
                              'labels': 'not-a-dict'}, 'spec': {}})
    docs.append({'apiVersion': 'v1', 'kind': 'Pod',
                 'metadata': {'name': 'already', 'namespace': 'x',
                              'labels': {'managed': 'true',
                                         'costcenter': 'c9'},
                              'annotations': {'policy.io/revision': 'r1'}},
                 'spec': {'containers': [{'name': 'c', 'image': 'i',
                                          'imagePullPolicy': 'Always'}]}})
    _j, want = _apply('kyverno_tpu', docs, 0, False, monkeypatch, fast)
    applier, got = _apply('kyverno_tpu_torch', docs, 0, False, monkeypatch,
                          fast)
    assert len(applier._fast_mutate) == (3 if fast else 0)
    assert _results(got) == _results(want)
    if fast:
        _s, slow = _apply('kyverno_tpu_torch', docs, 0, False, monkeypatch,
                          False)
        assert [(r.patched, r.rule_results) for r in slow] == \
            [(r.patched, r.rule_results) for r in got]


@pytest.mark.cuda
def test_applier_pool_forks_after_the_cuda_context():
    """The pool's workers fork from a process that holds a CUDA context
    and stay host-only: the same results as in-process."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the case is a fork after the CUDA '
                    'context exists')
    torch.zeros(1, device='cuda').sum().item()
    docs = _dump(300)
    _a, serial = _apply('kyverno_tpu_torch', docs, 0, False)
    applier, par = _apply('kyverno_tpu_torch', docs, 2, True)
    assert applier._pool is not None, 'the pool fell back in-process'
    assert _results(par) == _results(serial)
