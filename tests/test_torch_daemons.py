"""The port's admission-controller daemon (``kyverno_tpu_torch/cmd/
admission_controller.py``, on the CPU with ``device='cpu'``) against the
JAX package's on the same ``FakeClient`` contents: the webhook
configurations it writes (but for the random CA bytes), its admission
responses on ``/validate``, ``/mutate`` and ``/policyvalidate``, the
UpdateRequests it hands to the background controller and the
NetworkPolicies that controller then generates, the admission reports of
its Audit policy, the init job's cleanup, and the certificates its
renewer provisions.  The JAX daemon serves through its host engine loop
(the oracle of every device path); the port's serves from its scanners.
Every comparison is exact.
"""

import base64
import copy
import datetime
import json
import random

import pytest

from kyverno_tpu_torch import smokepack
from test_daemons import AUDIT_POLICY, GENERATE_POLICY

#: metadata the fake API server stamps per object (unique or clocked)
STAMPED = ('uid', 'resourceVersion', 'creationTimestamp', 'generation',
           'managedFields')

VALID_POLICY = AUDIT_POLICY
NO_MATCH = copy.deepcopy(AUDIT_POLICY)
del NO_MATCH['spec']['rules'][0]['match']
NO_RULES = {'apiVersion': 'kyverno.io/v1', 'kind': 'ClusterPolicy',
            'metadata': {'name': 'empty'}, 'spec': {'rules': []}}
DUPLICATE_RULE = copy.deepcopy(AUDIT_POLICY)
DUPLICATE_RULE['spec']['rules'].append(
    copy.deepcopy(DUPLICATE_RULE['spec']['rules'][0]))
BAD_OPERATOR = copy.deepcopy(AUDIT_POLICY)
BAD_OPERATOR['spec']['rules'][0]['validate'] = {'message': 'm', 'deny': {
    'conditions': {'any': [{'key': 'a', 'operator': 'Bogus',
                            'value': 1}]}}}
BAD_ACTION = copy.deepcopy(AUDIT_POLICY)
BAD_ACTION['spec']['validationFailureAction'] = 'block-everything'


def compliant_pod(i):
    """A Pod the smoke pack allows (an allowed review writes an
    admission report); odd ones carry the Audit policy's ``team``."""
    hardened = {'runAsNonRoot': True,
                'seccompProfile': {'type': 'RuntimeDefault'}}
    probe = {'httpGet': {'path': '/healthz', 'port': 8080}}
    labels = {'app': f'app-{i}'}
    if i % 2:
        labels['team'] = 'a'
    return {'apiVersion': 'v1', 'kind': 'Pod',
            'metadata': {'name': f'ok-{i}', 'namespace': 'default',
                         'labels': labels},
            'spec': {'securityContext': hardened, 'containers': [{
                'name': 'app', 'image': f'registry.example.com/app:1.{i}',
                'resources': {'requests': {'memory': '64Mi', 'cpu': '100m'},
                              'limits': {'memory': '128Mi'}},
                'livenessProbe': probe, 'readinessProbe': probe,
                'securityContext': dict(hardened,
                                        allowPrivilegeEscalation=False,
                                        capabilities={'drop': ['ALL']})}]}}


def review(uid, obj, operation='CREATE', group='', version='v1'):
    meta = obj.get('metadata') or {}
    return json.dumps({
        'apiVersion': 'admission.k8s.io/v1', 'kind': 'AdmissionReview',
        'request': {
            'uid': uid, 'operation': operation,
            'kind': {'group': group, 'version': version,
                     'kind': obj.get('kind', '')},
            'namespace': meta.get('namespace', ''),
            'name': meta.get('name', ''), 'object': obj,
            'userInfo': {'username': 'alice', 'groups': ['dev']}}}).encode()


def _cases():
    rng = random.Random(4)
    out = {}
    for i in range(3):
        out[f'validate-smoke-{i}'] = (
            '/validate/fail', review(f'v{i}', smokepack.make_config4_pod(
                rng, i)))
        out[f'mutate-{i}'] = ('/mutate', review(
            f'm{i}', smokepack.make_mutate_pod(rng, i)))
    for i in range(2):
        out[f'validate-compliant-{i}'] = ('/validate', review(
            f'ok{i}', compliant_pod(i)))
    out['validate-namespace'] = ('/validate', review('ns0', {
        'apiVersion': 'v1', 'kind': 'Namespace',
        'metadata': {'name': 'team-a'}}))
    for name, doc in (('valid', VALID_POLICY), ('no-match', NO_MATCH),
                      ('no-rules', NO_RULES),
                      ('duplicate-rule', DUPLICATE_RULE),
                      ('bad-operator', BAD_OPERATOR),
                      ('bad-action', BAD_ACTION)):
        out[f'policy-{name}'] = ('/policyvalidate', review(
            f'p-{name}', doc, group='kyverno.io'))
    return out


CASES = _cases()


def _cluster(client_cls):
    client = client_cls()
    docs = [p.raw for p in smokepack.load_smoke_pack('Enforce') +
            smokepack.load_mutate_pack()] + [AUDIT_POLICY, GENERATE_POLICY]
    for doc in docs:
        client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                               dict(copy.deepcopy(doc), kind='ClusterPolicy'))
    return client


class _Daemons:
    """The JAX daemon and the port's on two clients of equal contents,
    each ticked once; the port's validate scanner is up."""

    def __init__(self):
        from kyverno_tpu.cmd.admission_controller import \
            AdmissionController as JaxController
        from kyverno_tpu.cmd.internal import Setup as JaxSetup
        from kyverno_tpu.dclient.client import FakeClient as JaxClient
        from kyverno_tpu_torch.cmd.admission_controller import \
            AdmissionController
        from kyverno_tpu_torch.cmd.internal import Setup
        from kyverno_tpu_torch.dclient.client import FakeClient
        from kyverno_tpu_torch.policycache import cache as pcache
        self.jclient, self.tclient = _cluster(JaxClient), _cluster(FakeClient)
        self.jsetup = JaxSetup('jax', ['--disable-metrics'],
                               client=self.jclient)
        self.tsetup = Setup('port', ['--disable-metrics'],
                            client=self.tclient)
        self.jax = JaxController(self.jsetup, tls=False)
        # the reference answers from its host engine loop
        self.jax.handlers.device = False
        self.port = AdmissionController(self.tsetup, tls=False,
                                        device='cpu')
        self.jax.tick()
        self.port.tick()
        enforce = self.port.cache.get_policies(pcache.VALIDATE_ENFORCE,
                                               'Pod', 'default')
        assert self.port.handlers.wait_device_ready(enforce, timeout=120)
        self.answers = {}

    def serve(self, name):
        route, body = CASES[name]
        if name not in self.answers:
            self.answers[name] = (self.jax.server.handle(route, body),
                                  self.port.server.handle(route, body))
        return self.answers[name]

    def close(self):
        for daemon, setup in ((self.jax, self.jsetup),
                              (self.port, self.tsetup)):
            _stop(daemon, setup)


def _stop(daemon, setup, timeout=120.0):
    """Close ``daemon`` once its warm-up and every scanner build it
    started are done: a build thread still inside a torch op when the
    interpreter exits aborts the process."""
    import time
    daemon.warmer.wait(timeout)
    deadline = time.monotonic() + timeout
    while daemon.handlers._building and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not daemon.handlers._building
    daemon.close()
    setup.shutdown()


@pytest.fixture(scope='module')
def daemons():
    from kyverno_tpu_torch.observability import executables
    from kyverno_tpu_torch.observability.metrics import set_global_registry
    d = _Daemons()
    try:
        yield d
    finally:
        d.close()
        set_global_registry(None)
        executables.disable()


def _strip(obj):
    """``obj`` without the metadata the fake API server stamps and the
    clocked fields of report results."""
    obj = copy.deepcopy(obj)
    meta = obj.get('metadata') or {}
    for k in STAMPED:
        meta.pop(k, None)
    for r in obj.get('spec', {}).get('results', []) or \
            obj.get('results', []) or []:
        r.pop('timestamp', None)
    return obj


@pytest.mark.parametrize('name', sorted(CASES))
def test_admission_responses_byte_equal(daemons, name):
    want, got = daemons.serve(name)
    assert got == want


def test_policy_validation_allows_only_the_valid_policy(daemons):
    allowed = {name: json.loads(daemons.serve(name)[1])['response'][
        'allowed'] for name in CASES if name.startswith('policy-')}
    assert allowed['policy-valid'] is True
    assert not [n for n, a in allowed.items()
                if n != 'policy-valid' and a]


@pytest.mark.parametrize('kind,name', [
    ('ValidatingWebhookConfiguration',
     'kyverno-resource-validating-webhook-cfg'),
    ('MutatingWebhookConfiguration',
     'kyverno-resource-mutating-webhook-cfg'),
    ('ValidatingWebhookConfiguration',
     'kyverno-policy-validating-webhook-cfg'),
    ('MutatingWebhookConfiguration',
     'kyverno-policy-mutating-webhook-cfg'),
    ('MutatingWebhookConfiguration',
     'kyverno-verify-mutating-webhook-cfg')])
def test_webhook_configurations_equal_but_for_the_ca(daemons, kind, name):
    api = 'admissionregistration.k8s.io/v1'
    want = _strip(daemons.jclient.get_resource(api, kind, '', name))
    got = _strip(daemons.tclient.get_resource(api, kind, '', name))
    bundle = base64.b64encode(
        daemons.port.cert_renewer.ca_bundle()).decode()
    for w in got['webhooks']:
        assert w['clientConfig'].pop('caBundle') == bundle
    for w in want['webhooks']:
        w['clientConfig'].pop('caBundle')
    assert got == want


def test_update_requests_and_generated_network_policy(daemons):
    """The Namespace's admission hands one UpdateRequest to the
    background controller in each package; their specs are equal, and
    so is the NetworkPolicy each background controller then creates."""
    from kyverno_tpu.cmd.background_controller import \
        BackgroundController as JaxBackground
    from kyverno_tpu_torch.cmd.background_controller import \
        BackgroundController
    daemons.serve('validate-namespace')
    ur = ('kyverno.io/v1beta1', 'UpdateRequest', 'kyverno', None)
    jurs = daemons.jclient.list_resource(*ur)
    turs = daemons.tclient.list_resource(*ur)
    assert len(turs) == 1
    assert [u['spec'] for u in turs] == [u['spec'] for u in jurs]
    ns = {'apiVersion': 'v1', 'kind': 'Namespace',
          'metadata': {'name': 'team-a'}}
    daemons.jclient.create_resource('v1', 'Namespace', '', ns)
    daemons.tclient.create_resource('v1', 'Namespace', '',
                                    copy.deepcopy(ns))
    JaxBackground(daemons.jsetup).tick()
    BackgroundController(daemons.tsetup).tick()
    nps = []
    for client, urs in ((daemons.jclient, jurs), (daemons.tclient, turs)):
        got = [_strip(n) for n in client.list_resource(
            'networking.k8s.io/v1', 'NetworkPolicy', 'team-a', None)]
        # each names its own UpdateRequest, whose name a process-wide
        # counter numbers (it differs with what the process ran before)
        for n in got:
            labels = n['metadata']['labels']
            assert labels.pop('policy.kyverno.io/gr-name') == \
                urs[0]['metadata']['name']
        nps.append(got)
    assert len(nps[1]) == 1 and nps[1] == nps[0]
    assert nps[1][0]['metadata']['name'] == 'default-deny'
    after = [[(u['spec'], u.get('status')) for u in client.list_resource(
        *ur)] for client in (daemons.jclient, daemons.tclient)]
    assert after[1] == after[0]


def test_admission_reports_of_the_audit_policy(daemons):
    """Each allowed Pod review writes one admission report, with the
    Audit policy's result beside the Enforce policies'."""
    for i in range(2):
        daemons.serve(f'validate-compliant-{i}')
    daemons.jax.flush_audits()
    daemons.port.flush_audits()
    reports = [sorted((_strip(r) for r in client.list_resource(
        'kyverno.io/v1alpha2', 'AdmissionReport', '', None)),
        key=lambda r: r['metadata']['name'])
        for client in (daemons.jclient, daemons.tclient)]
    assert len(reports[1]) == 2 and reports[1] == reports[0]
    policies = {r['policy'] for rep in reports[1]
                for r in rep['spec']['results']}
    assert 'need-team' in policies


def _stale_cluster(package):
    import importlib
    client = importlib.import_module(
        f'{package}.dclient.client').FakeClient()
    internal = importlib.import_module(f'{package}.cmd.internal')
    setup = internal.Setup('init', ['--disable-metrics'], client=client)
    ctl = importlib.import_module(f'{package}.cmd.admission_controller')
    kwargs = {'device': 'cpu'} if package == 'kyverno_tpu_torch' else {}
    daemon = ctl.AdmissionController(setup, tls=False, **kwargs)
    client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                           copy.deepcopy(AUDIT_POLICY))
    daemon.tick()
    daemon.reconciler.heartbeat()
    return client, daemon, setup


def test_init_cleans_the_same_stale_state():
    from kyverno_tpu.cmd.init import cleanup_stale_state as jax_cleanup
    from kyverno_tpu_torch.cmd.init import cleanup_stale_state
    left, removed = [], []
    for package, cleanup in (('kyverno_tpu', jax_cleanup),
                             ('kyverno_tpu_torch', cleanup_stale_state)):
        client, daemon, setup = _stale_cluster(package)
        removed.append(cleanup(client))
        left.append(sorted((o['apiVersion'], o['kind'],
                            o['metadata'].get('name'))
                           for o in client._store.values()))
        _stop(daemon, setup)
    assert removed[1] == removed[0] >= 2
    assert left[1] == left[0]
    assert not [o for o in left[1] if o[1] == 'Lease']


def _cert_fields(ca_pem, cert_pem):
    from cryptography import x509
    from cryptography.hazmat.primitives.asymmetric import padding
    ca = x509.load_pem_x509_certificate(ca_pem)
    cert = x509.load_pem_x509_certificate(cert_pem)
    # the pair is signed by the CA
    ca.public_key().verify(cert.signature, cert.tbs_certificate_bytes,
                           padding.PKCS1v15(),
                           cert.signature_hash_algorithm)
    ca.public_key().verify(ca.signature, ca.tbs_certificate_bytes,
                           padding.PKCS1v15(), ca.signature_hash_algorithm)

    def fields(c):
        exts = {e.oid.dotted_string: (e.critical, repr(e.value))
                for e in c.extensions}
        return {'subject': c.subject.rfc4514_string(),
                'issuer': c.issuer.rfc4514_string(),
                'validity': c.not_valid_after_utc - c.not_valid_before_utc,
                'key_size': c.public_key().key_size,
                'hash': c.signature_hash_algorithm.name,
                'extensions': exts}
    return fields(ca), fields(cert)


def _renewed(package):
    import importlib
    certs = importlib.import_module(f'{package}.tls.certs')
    client = importlib.import_module(
        f'{package}.dclient.client').FakeClient()
    now = datetime.datetime(2026, 1, 2, tzinfo=datetime.timezone.utc)
    ca, cert, _key = certs.CertRenewer(client).renew(now=now)
    secrets = sorted(
        (s['metadata']['name'], s['type'], sorted(s['data']))
        for s in client.list_resource('v1', 'Secret', 'kyverno', None))
    return certs, client, ca, cert, secrets


@pytest.mark.parametrize('part', ['secrets', 'ca', 'pair'])
def test_cert_renewal_provisions_the_same_certificates(part):
    jax, port = _renewed('kyverno_tpu'), _renewed('kyverno_tpu_torch')
    if part == 'secrets':
        assert port[4] == jax[4] and len(port[4]) == 2
        assert {n for n, _t, _d in port[4]} == {port[0].CA_SECRET,
                                                port[0].TLS_SECRET}
        return
    want = _cert_fields(jax[2], jax[3])
    got = _cert_fields(port[2], port[3])
    idx = 0 if part == 'ca' else 1
    assert got[idx] == want[idx]


def test_cert_renewal_keeps_and_rotates_like_the_reference():
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.tls.certs import CertRenewer, cert_expiry
    renewer = CertRenewer(FakeClient())
    ca1, cert1, _ = renewer.renew()
    ca2, cert2, _ = renewer.renew()
    assert ca1 == ca2 and cert1 == cert2
    near_expiry = cert_expiry(cert1) - datetime.timedelta(days=1)
    _, cert3, _ = renewer.renew(now=near_expiry)
    assert cert3 != cert1


def test_daemon_runs_on_the_card_by_default(monkeypatch):
    """Without CUDA the daemon raises instead of serving from the host."""
    import torch
    from kyverno_tpu_torch.cmd.admission_controller import \
        AdmissionController
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.dclient.client import FakeClient
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('KTPU_WARM', '0')
    setup = Setup('t', ['--disable-metrics'], client=FakeClient())
    with pytest.raises(RuntimeError, match='CUDA'):
        AdmissionController(setup, tls=False)


def test_warm_up_over_https_on_the_cpu(tmp_path, monkeypatch):
    """The daemon with TLS on the CPU: ``/health/warmup`` turns ready
    over a connection verified against the CA bundle, the warmer names
    the compiled scanner, and ticks that find the same policies keep the
    scanner the warm-up built (no rebuild, no host loop)."""
    import chip_smoke
    from kyverno_tpu_torch.cmd.admission_controller import \
        AdmissionController
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.observability import provenance
    from kyverno_tpu_torch.policycache import cache as pcache
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    setup = Setup('t', ['--disable-metrics'], client=_cluster(FakeClient))
    daemon = AdmissionController(setup, port=0, tls=True, device='cpu')
    try:
        daemon.server.start()
        port = daemon.server.port
        daemon.tick()
        ca = daemon.cert_renewer.ca_bundle()
        assert daemon.warmer.wait(120)
        code, body = chip_smoke._https(port, ca, 'GET', '/health/warmup')
        assert code == 200 and json.loads(body)['state'] == 'ready'
        assert daemon.warmer.detail.startswith('compiled scanner serving')
        daemon.tick()
        rec = provenance.configure(flight_n=8, dump_dir=str(tmp_path))
        try:
            route, body = CASES['validate-smoke-0']
            code, _resp = chip_smoke._https(port, ca, 'POST', route, body)
            assert code == 200
            assert [r.path for r in rec.records()] == ['sync']
        finally:
            provenance.disable()
        enforce = daemon.cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod',
                                            'default')
        assert daemon.handlers._device_scanner(enforce) is not None
    finally:
        _stop(daemon, setup)
