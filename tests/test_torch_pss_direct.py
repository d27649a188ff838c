"""The scan's podSecurity rows built from the check library
(``compiler/scan.py`` ``_PssRows``) against the host engine's row
(``BatchScanner._materialize``), on the CPU: every field of the rule
response and its report result, the evaluation shared between the
baseline and restricted programs of one Pod, the gate that keeps other
rules and admission scans on the engine, the fallback on an exception,
whole passes with the direct rows on and off, and the counter."""

import pickle
import random
import types

import numpy as np
import pytest
import yaml

from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.compiler import scan as scan_mod
from kyverno_tpu_torch.compiler.ir import STATUS_FAIL, STATUS_PASS
from kyverno_tpu_torch.compiler.scan import BatchScanner
from kyverno_tpu_torch.engine.api import PolicyContext
from kyverno_tpu_torch.observability import coverage
from kyverno_tpu_torch.observability import device as devtel
from kyverno_tpu_torch.observability.metrics import MetricsRegistry
from kyverno_tpu_torch.reports.results import _rule_result

NOW = 1_700_000_000
PSS_POLICIES = {'pss-baseline', 'pss-restricted', 'pss-deployments'}

#: podSecurity rules beside the smoke pack's: pinned versions and none
#: (autogen on, so Deployments and CronJobs get rules too), and a rule
#: with a context and one with preconditions, which keep the engine
EXTRA_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: pss-pinned
spec:
  rules:
    - name: baseline-124
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        podSecurity: {level: baseline, version: v1.24}
    - name: restricted-129
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        podSecurity: {level: restricted, version: v1.29}
    - name: baseline-unversioned
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        podSecurity: {level: baseline}
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: pss-gated
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: with-context
      match: {any: [{resources: {kinds: [Pod]}}]}
      context:
        - name: tier
          variable: {value: web}
      validate:
        podSecurity: {level: restricted, version: latest}
    - name: with-preconditions
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.kind }}"
            operator: Equals
            value: Pod
      validate:
        podSecurity: {level: baseline, version: latest}
"""


def _scanner(monkeypatch, policies, chunk=64, flush=32):
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    sc = BatchScanner(policies, device='cpu')
    sc.CHUNK = chunk
    sc.REPORT_FLUSH_ROWS = flush
    sc.ENCODE_TIMEOUT_S = 60.0
    return sc


def _policies(extra=False):
    pols = smokepack.load_smoke_pack('Audit')
    if extra:
        pols += [Policy(d) for d in yaml.safe_load_all(EXTRA_PACK) if d]
    return pols


def _container(name, **sc):
    c = {'name': name, 'image': 'nginx:1.25.3'}
    if sc:
        c['securityContext'] = sc
    return c


def _pod(name, spec, annotations=None):
    meta = {'name': name, 'namespace': 'default'}
    if annotations:
        meta['annotations'] = annotations
    return {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': meta,
            'spec': spec}


RESTRICTED_OK = {
    'securityContext': {'runAsNonRoot': True,
                        'seccompProfile': {'type': 'RuntimeDefault'}},
    'containers': [_container('c0', allowPrivilegeEscalation=False,
                              capabilities={'drop': ['ALL']})]}


def _hand_made():
    """Pods that reach each corner of the check library, the template
    kinds, a kind the podSecurity rule rejects and an empty object."""
    pods = [
        _pod('init-ephemeral', {
            'containers': [_container('c0')],
            'initContainers': [_container('init', privileged=True)],
            'ephemeralContainers': [_container(
                'debug', capabilities={'add': ['SYS_ADMIN']})]}),
        _pod('apparmor', {'containers': [_container('c0')]}, {
            'container.apparmor.security.beta.kubernetes.io/c0':
                'unconfined'}),
        _pod('seccomp-annotations', {'containers': [_container('c0')]}, {
            'seccomp.security.alpha.kubernetes.io/pod': 'unconfined',
            'container.seccomp.security.alpha.kubernetes.io/c0':
                'unconfined'}),
        _pod('sysctls', {'containers': [_container('c0')],
                         'securityContext': {'sysctls': [
                             {'name': 'kernel.msgmax', 'value': '1'},
                             {'name': 'net.core.rmem_max',
                              'value': '1'}]}}),
        _pod('host-path', {'containers': [_container('c0')],
                           'hostNetwork': True, 'hostIPC': True,
                           'volumes': [{'name': 'v', 'hostPath': {
                               'path': '/etc'}}]}),
        _pod('windows', {'os': {'name': 'windows'},
                         'containers': [_container('c0')]}),
        _pod('restricted-ok', RESTRICTED_OK),
        {'apiVersion': 'apps/v1', 'kind': 'Deployment',
         'metadata': {'name': 'deploy', 'namespace': 'default'},
         'spec': {'template': {
             'metadata': {'annotations': {
                 'container.apparmor.security.beta.kubernetes.io/c0':
                     'unconfined'}},
             'spec': {'containers': [_container('c0', privileged=True)],
                      'hostPID': True}}}},
        {'apiVersion': 'apps/v1', 'kind': 'Deployment',
         'metadata': {'name': 'deploy-ok', 'namespace': 'default'},
         'spec': {'template': {'spec': RESTRICTED_OK}}},
        {'apiVersion': 'batch/v1', 'kind': 'CronJob',
         'metadata': {'name': 'cron', 'namespace': 'default'},
         'spec': {'jobTemplate': {'spec': {'template': {'spec': {
             'containers': [_container('c0', runAsUser=0)],
             'initContainers': [_container(
                 'i0', procMount='Unmasked')]}}}}}},
        {'apiVersion': 'v1', 'kind': 'ConfigMap',
         'metadata': {'name': 'cm', 'namespace': 'default'}},
        {},
    ]
    return pods


def _seeded(n, seed=11):
    rng = random.Random(seed)
    half = n // 2
    return ([smokepack.make_pod(rng, i) for i in range(half)] +
            [smokepack.make_restricted_pod(rng, i) for i in range(half, n)])


def _fields(rr):
    if rr is None:
        return None
    return (rr.name, rr.rule_type, rr.message, rr.status,
            rr.pod_security_checks)


def _result(rr):
    return None if rr is None else _rule_result(
        rr, 'pss', True, 'Pod Security', 'medium', {'seconds': NOW}, NOW)


def _by_name(sc):
    return {spec.name: j for j, spec in sc._pss_specs.items()}


# -- equality ---------------------------------------------------------------

@pytest.mark.parametrize('full', [False, True], ids=['own-level', 'full'])
def test_direct_rows_equal_the_engine_rows(monkeypatch, full):
    """Every direct program on every resource, each program alone in
    its window: its response and report result equal the engine's,
    whether the Pod's checks ran at the program's own level or at the
    full level and were filtered to baseline."""
    sc = _scanner(monkeypatch, _policies(extra=True))
    resources = _seeded(300) + _hand_made()
    levels = {spec.level for spec in sc._pss_specs.values()}
    assert {'baseline', 'restricted'} <= levels
    direct = 0
    for j, spec in sc._pss_specs.items():
        prog = sc.cps.programs[j]
        pss = scan_mod._PssRows(sc._pss_specs,
                                np.full(len(resources), full))
        for k, res in enumerate(resources):
            want = sc._materialize(prog, res)
            got = sc._materialize_row(j, prog, res, k, pss)
            assert _fields(got) == _fields(want), (spec.name, res)
            assert _result(got) == _result(want)
            if res.get('kind') in ('Pod', 'Deployment', 'CronJob'):
                assert pss.response(j, k, res) is not None
                direct += 1
            else:
                # a kind podSecurity rejects, or a DELETE-shaped empty
                # object: the engine's row (an error row, or none)
                assert pss.response(j, k, res) is None
        assert pss.evaluated == len(resources) - 2
    assert direct > 1000
    # the hand-made Pods fail in the corners they were made for
    fails = {res['metadata']['name']: sc._materialize(
        sc.cps.programs[_by_name(sc)['restricted']], res).message
        for res in _hand_made()[:7]}
    assert 'forbidden AppArmor profile' in fails['apparmor']
    assert 'seccompProfile' in fails['seccomp-annotations']
    assert 'forbidden sysctls' in fails['sysctls']
    assert 'hostPath volumes' in fails['host-path']
    assert 'passed' in fails['restricted-ok']


def test_template_kinds_take_the_template_branch(monkeypatch):
    """Deployment (``pss-deployments`` and the autogen rules) and
    CronJob (the autogen cronjob rules): rows built from the Pod
    template, equal to the engine's."""
    sc = _scanner(monkeypatch, _policies(extra=True))
    names = _by_name(sc)
    assert 'restricted-deploy' in names
    cron = [n for n in names if n.startswith('autogen-cronjob-')]
    assert cron
    deploy, deploy_ok, cronjob = _hand_made()[7:10]
    pss = scan_mod._PssRows(sc._pss_specs, np.zeros(3, bool))
    for name, k, res, status in [
            ('restricted-deploy', 0, deploy, 'fail'),
            ('restricted-deploy', 1, deploy_ok, 'pass'),
            (cron[0], 2, cronjob, 'fail')]:
        j = names[name]
        got = pss.response(j, k, res)
        want = sc._materialize(sc.cps.programs[j], res)
        assert got is not None and str(got.status) == status
        assert _fields(got) == _fields(want)


# -- the shared evaluation --------------------------------------------------

@pytest.mark.parametrize('order,full_rows,evaluated,shared', [
    (('baseline', 'restricted'), True, 1, 1),
    (('restricted', 'baseline'), True, 1, 1),
    (('restricted', 'baseline'), False, 1, 1),
    # the mask did not foresee the restricted program: it runs again
    (('baseline', 'restricted'), False, 2, 0),
], ids=['baseline-first', 'restricted-first', 'restricted-first-unmarked',
        'baseline-first-unmarked'])
def test_one_evaluation_serves_both_levels(monkeypatch, order, full_rows,
                                           evaluated, shared):
    sc = _scanner(monkeypatch, _policies())
    names = _by_name(sc)
    pods = _seeded(200, seed=23) + _hand_made()[:7]
    pss = scan_mod._PssRows(sc._pss_specs, np.full(len(pods), full_rows))
    for k, pod in enumerate(pods):
        for name in order:
            j = names[name]
            got = pss.response(j, k, pod)
            want = sc._materialize(sc.cps.programs[j], pod)
            assert _fields(got) == _fields(want), (name, pod)
    assert pss.evaluated == evaluated * len(pods)
    assert pss.shared == shared * len(pods)


def test_the_window_marks_rows_a_full_level_program_leaves_on(monkeypatch):
    """``_pss_rows`` asks for the full check set on a row when a
    full-level program matches it with a cell that leaves the device,
    and only where that program's column counts."""
    sc = _scanner(monkeypatch, _policies())
    jr = _by_name(sc)['restricted']
    jb = _by_name(sc)['baseline']
    p = len(sc.cps.programs)
    match = np.zeros((4, p), bool)
    status = np.full((4, p), STATUS_PASS, np.int8)
    match[:, jb] = True
    status[:, jb] = STATUS_FAIL
    match[0, jr], status[0, jr] = True, STATUS_FAIL   # leaves the device
    match[1, jr], status[1, jr] = True, STATUS_PASS   # synthesized
    status[2, jr] = STATUS_FAIL                       # does not match
    match[3, jr], status[3, jr] = True, STATUS_FAIL
    cols_ok = np.ones(p, bool)
    assert sc._pss_rows(match, status).full_rows.tolist() == \
        [True, False, False, True]
    cols_ok[jr] = False
    assert sc._pss_rows(match, status, cols_ok).full_rows.tolist() == \
        [False] * 4


# -- the gate ---------------------------------------------------------------

def test_rules_with_context_or_preconditions_keep_the_engine(monkeypatch):
    sc = _scanner(monkeypatch, _policies(extra=True))
    gated = {'with-context', 'with-preconditions'}
    progs = [prog for prog in sc.cps.programs
             if prog.rule_name in gated]
    assert {prog.rule_name for prog in progs} == gated
    assert all(prog.pss is not None for prog in progs)
    assert not gated & set(_by_name(sc))
    assert all(scan_mod._pss_spec(prog) is None for prog in progs)
    assert {'baseline', 'restricted', 'restricted-deploy', 'baseline-124',
            'restricted-129', 'baseline-unversioned'} <= set(_by_name(sc))


@pytest.mark.parametrize('raw', [
    {'name': 'r', 'validate': {'podSecurity': {
        'level': 'restricted', 'version': 'latest',
        'exclude': [{'controlName': 'Capabilities'}]}}},
    {'name': 'r', 'validate': {'podSecurity': {
        'level': 'baseline', 'version': 'one-point-two'}}},
    {'name': 'r', 'context': [{'name': 'x', 'variable': {'value': 1}}],
     'validate': {'podSecurity': {'level': 'baseline'}}},
    {'name': 'r', 'preconditions': {'all': []},
     'validate': {'podSecurity': {'level': 'baseline'}}},
], ids=['exclude', 'bad-version', 'context', 'preconditions'])
def test_the_spec_refuses_what_the_engine_must_decide(raw):
    level = raw['validate']['podSecurity']['level']
    prog = types.SimpleNamespace(pss=(level, 'latest'), rule_raw=raw)
    assert scan_mod._pss_spec(prog) is None
    plain = {'name': 'r', 'validate': {
        'podSecurity': {'level': level, 'version': 'latest'}}}
    assert scan_mod._pss_spec(
        types.SimpleNamespace(pss=(level, 'latest'), rule_raw=plain)) == \
        scan_mod._PssSpec('r', level, 'latest', level != 'baseline')


def test_a_non_stock_engine_keeps_the_engine(monkeypatch):
    from kyverno_tpu_torch.cli.common import MockContextLoader
    from kyverno_tpu_torch.engine.engine import Engine
    from kyverno_tpu_torch.pss.evaluate import evaluate_pod_security
    sc = _scanner(monkeypatch, _policies())
    n = len(sc.cps.programs)
    match = np.ones((2, n), bool)
    status = np.full((2, n), STATUS_FAIL, np.int8)
    assert sc._pss_rows(match, status) is not None
    for engine in (Engine(pss_evaluator=lambda rule, pod:
                          evaluate_pod_security(rule, pod)),
                   Engine(context_loader=MockContextLoader())):
        sc.engine = engine
        assert sc._pss_rows(match, status) is None


def _no_direct_rows(monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError('direct podSecurity row in an admission scan')
    monkeypatch.setattr(scan_mod._PssRows, 'response', refuse)


@pytest.mark.parametrize('batch', [1, 100], ids=['row-wise', 'columnar'])
def test_a_scan_with_a_pctx_factory_keeps_the_engine(monkeypatch, batch):
    """Admission scans pass a ``pctx_factory``: their host rows re-run
    the engine.  A CREATE gives the background rows; a DELETE gives no
    podSecurity row at all, where the direct path would have given a
    FAIL."""
    pols = _policies()
    sc = _scanner(monkeypatch, pols)
    pods = _seeded(batch, seed=31)
    background = sc.scan(pods)
    _no_direct_rows(monkeypatch)

    def rules(responses):
        return {(r.policy_response.policy_name, x.name):
                (str(x.status), x.message)
                for r in responses for x in r.policy_response.rules
                if r.policy_response.policy_name in PSS_POLICIES}

    create = sc.scan(pods, pctx_factory=lambda doc: PolicyContext(
        pols[0], new_resource=doc, admission_operation='CREATE'))
    assert [rules(r) for r in create] == [rules(r) for r in background]
    delete = sc.scan(pods, pctx_factory=lambda doc: PolicyContext(
        pols[0], old_resource=doc, admission_operation='DELETE'))
    failed = [rules(r) for r in background]
    assert any(v[0] == 'fail' for row in failed for v in row.values())
    for row in (rules(r) for r in delete):
        assert all(status == 'pass' for status, _msg in row.values())


# -- the fallback -----------------------------------------------------------

def test_an_exception_in_the_checks_gives_the_engine_row(monkeypatch):
    sc = _scanner(monkeypatch, _policies())
    pods = _seeded(40, seed=41)

    def broken(level, pod):
        raise RuntimeError('check library fault')
    monkeypatch.setattr(scan_mod, 'evaluate_pss', broken)
    for j, spec in sc._pss_specs.items():
        prog = sc.cps.programs[j]
        pss = scan_mod._PssRows(sc._pss_specs, np.ones(len(pods), bool))
        for k, pod in enumerate(pods):
            assert pss.response(j, k, pod) is None
            assert _fields(sc._materialize_row(j, prog, pod, k, pss)) == \
                _fields(sc._materialize(prog, pod))
        assert pss.evaluated == pss.shared == 0


# -- whole passes and the counter -------------------------------------------

def _pass(sc):
    return [pickle.dumps((results, summary)) for results, summary, _p in
            sc.scan_report_results(_PASS_PODS, now=NOW)]


_PASS_PODS = _seeded(260, seed=53) + _hand_made()[:10]


def _forced_off(monkeypatch):
    monkeypatch.setattr(BatchScanner, '_pss_rows',
                        lambda self, *a, **k: None)


def test_report_pass_is_the_same_with_direct_rows_on_and_off(monkeypatch):
    """``scan_report_results`` yields the same bytes per Pod, and the
    coverage ledger attributes the same rows, with the direct rows on
    and with them forced off; the counter counts what the pass did."""
    pols = _policies(extra=True)
    reg = devtel.configure(MetricsRegistry())
    ledger = coverage.configure(MetricsRegistry())
    try:
        on = _pass(_scanner(monkeypatch, pols))
        evaluated = reg.counter_value(devtel.PSS_DIRECT_ROWS,
                                      source='evaluated')
        shared = reg.counter_value(devtel.PSS_DIRECT_ROWS, source='shared')
        cov_on = ledger.report()
        coverage.configure(MetricsRegistry())
        with monkeypatch.context() as mp:
            _forced_off(mp)
            off = _pass(_scanner(monkeypatch, pols))
        cov_off = coverage.ledger().report()
        assert reg.counter_value(devtel.PSS_DIRECT_ROWS,
                                 source='evaluated') == evaluated
    finally:
        devtel.disable()
        coverage.disable()
    assert on == off
    assert cov_on == cov_off
    assert cov_on['fallbacks']['pss']['unsynthesizable_message'] > 0
    # the rows the direct path built: every podSecurity row that is not
    # a synthesized PASS, but those of the gated rules
    direct = {'pss-baseline', 'pss-restricted', 'pss-deployments',
              'pss-pinned'}
    per_pod = [sum(1 for r in pickle.loads(row)[0]
                   if r['policy'] in direct and r['result'] != 'pass')
               for row in on]
    want_evaluated = sum(1 for c in per_pod if c)
    assert want_evaluated > 100
    assert evaluated == want_evaluated
    assert shared == sum(per_pod) - want_evaluated
    assert shared > want_evaluated


@pytest.mark.parametrize('batch', [17, 300], ids=['row-wise', 'columnar'])
def test_scan_is_the_same_with_direct_rows_on_and_off(monkeypatch, batch):
    pols = _policies(extra=True)
    pods = _PASS_PODS[:batch]

    def table(out):
        return [[(r.policy_response.policy_name,
                  [(x.name, str(x.status), x.message,
                    x.pod_security_checks)
                   for x in r.policy_response.rules]) for r in row]
                for row in out]
    reg = devtel.configure(MetricsRegistry())
    try:
        on = table(_scanner(monkeypatch, pols).scan(pods))
        assert reg.counter_value(devtel.PSS_DIRECT_ROWS,
                                 source='evaluated') > 0
    finally:
        devtel.disable()
    with monkeypatch.context() as mp:
        _forced_off(mp)
        off = table(_scanner(monkeypatch, pols).scan(pods))
    assert on == off


def test_the_counter_is_quiet_without_telemetry(monkeypatch):
    """Unconfigured, the window counts and raises nothing."""
    calls = []
    monkeypatch.setattr(devtel, '_registry', None)
    real = devtel.add_pss_direct_rows
    monkeypatch.setattr(devtel, 'add_pss_direct_rows',
                        lambda e, s: calls.append((e, s)) or real(e, s))
    sc = _scanner(monkeypatch, _policies())
    list(sc.scan_report_results(_PASS_PODS[:64], now=NOW))
    # one call per report window: 64 rows in windows of 32
    assert len(calls) == 2 and sum(e for e, _s in calls) > 0
