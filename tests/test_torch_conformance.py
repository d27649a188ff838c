"""The port's conformance package against the JAX package's: the load
generator draws the same traffic and churn, the scenario runner gives
the same counts and failures on a corpus written under ``tmp_path``,
and the kuttl harness replays one small suite to the same outcome (the
JAX daemons under ``x64_shim``, the port's on the CPU)."""

import os

import pytest
import yaml

import chip_smoke
from kyverno_tpu.conformance import kuttl as jax_kuttl
from kyverno_tpu.conformance import loadgen as jax_loadgen
from kyverno_tpu.conformance import scenarios as jax_scenarios
from kyverno_tpu_torch.conformance import kuttl as port_kuttl
from kyverno_tpu_torch.conformance import loadgen as port_loadgen
from kyverno_tpu_torch.conformance import scenarios as port_scenarios
from test_torch_reference import x64_shim

SEEDS = (0, 7, 4321)
INDICES = 256


@pytest.mark.parametrize('seed', SEEDS)
def test_synthetic_cluster_draws_the_same_traffic(seed):
    kw = dict(seed=seed, poison_ratio=1 / 8)
    jc = jax_loadgen.SyntheticCluster(**kw)
    pc = port_loadgen.SyntheticCluster(**kw)
    assert pc.exception_users == jc.exception_users
    for i in range(INDICES):
        assert pc.request(i) == jc.request(i), i
        assert pc.review_bytes(i) == jc.review_bytes(i), i
        assert pc.is_poison(i) == jc.is_poison(i)
    assert pc.poison_count(INDICES) == jc.poison_count(INDICES) > 0
    assert pc.fault_spec() == jc.fault_spec()
    assert pc.exception_docs() == jc.exception_docs()
    assert [d for _t, d in pc.arrivals(32, pattern='trickle')] == \
        [d for _t, d in jc.arrivals(32, pattern='trickle')]


@pytest.mark.parametrize('seed', SEEDS)
def test_churn_schedule_and_apply_churn_agree(seed):
    from kyverno_tpu_torch import smokepack
    raws = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    jc = jax_loadgen.SyntheticCluster(seed=seed)
    pc = port_loadgen.SyntheticCluster(seed=seed)
    kw = dict(events=3, actions=('edit', 'add', 'delete'))
    jev = jc.churn_schedule(INDICES, len(raws), **kw)
    pev = pc.churn_schedule(INDICES, len(raws), **kw)
    assert [e.to_dict() for e in pev] == [e.to_dict() for e in jev]
    for je, pe in zip(jev, pev):
        got = port_loadgen.apply_churn(raws, pe)
        assert got == jax_loadgen.apply_churn(raws, je)
        assert got != raws
    assert raws == [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]


# ---------------------------------------------------------------------------
# scenarios: a corpus in the reference's layout, under tmp_path

_FILES = {
    'policies/add-label.yaml': {
        'apiVersion': 'kyverno.io/v1', 'kind': 'ClusterPolicy',
        'metadata': {'name': 'add-label'},
        'spec': {'rules': [{
            'name': 'add-team', 'match': {'any': [
                {'resources': {'kinds': ['Pod']}}]},
            'mutate': {'patchStrategicMerge': {
                'metadata': {'labels': {'+(team)': 'platform'}}}}}]}},
    'policies/require-team.yaml': {
        'apiVersion': 'kyverno.io/v1', 'kind': 'ClusterPolicy',
        'metadata': {'name': 'require-team'},
        'spec': {'validationFailureAction': 'Enforce', 'rules': [{
            'name': 'check-team', 'match': {'any': [
                {'resources': {'kinds': ['Pod']}}]},
            'validate': {'message': "label 'team' is required",
                         'pattern': {'metadata': {
                             'labels': {'team': '?*'}}}}}]}},
    'policies/ns-quota.yaml': {
        'apiVersion': 'kyverno.io/v1', 'kind': 'ClusterPolicy',
        'metadata': {'name': 'ns-config'},
        'spec': {'rules': [{
            'name': 'default-config', 'match': {'any': [
                {'resources': {'kinds': ['Namespace']}}]},
            'generate': {
                'apiVersion': 'v1', 'kind': 'ConfigMap',
                'name': 'defaults',
                'namespace': '{{request.object.metadata.name}}',
                'synchronize': False,
                'data': {'data': {'tier': 'standard'}}}}]}},
    'resources/pod.yaml': {
        'apiVersion': 'v1', 'kind': 'Pod',
        'metadata': {'name': 'web', 'namespace': 'default'},
        'spec': {'containers': [{'name': 'c', 'image': 'nginx:1.25'}]}},
    'resources/pod-patched.yaml': {
        'apiVersion': 'v1', 'kind': 'Pod',
        'metadata': {'name': 'web', 'namespace': 'default',
                     'labels': {'team': 'platform'}},
        'spec': {'containers': [{'name': 'c', 'image': 'nginx:1.25'}]}},
    'resources/namespace.yaml': {
        'apiVersion': 'v1', 'kind': 'Namespace',
        'metadata': {'name': 'team-a'}},
}


def _rules(policy, rule, rtype, status, message=None):
    r = {'name': rule, 'type': rtype, 'status': status}
    if message is not None:
        r['message'] = message
    return {'policy': {'name': policy},
            'resource': {'kind': 'Pod', 'namespace': 'default',
                         'name': 'web'}, 'rules': [r]}


_SCENARIOS = {
    'scenarios/mutate.yaml': [{
        'input': {'policy': 'policies/add-label.yaml',
                  'resource': 'resources/pod.yaml'},
        'expected': {'mutation': {
            'patchedresource': 'resources/pod-patched.yaml',
            'policyresponse': _rules('add-label', 'add-team', 'Mutation',
                                     'pass')}}}],
    'scenarios/validate.yaml': [
        {'input': {'policy': 'policies/require-team.yaml',
                   'resource': 'resources/pod.yaml'},
         'expected': {'validation': {'policyresponse': _rules(
             'require-team', 'check-team', 'Validation', 'fail')}}},
        {'input': {'policy': 'policies/require-team.yaml',
                   'resource': 'resources/pod-patched.yaml'},
         'expected': {'validation': {'policyresponse': _rules(
             'require-team', 'check-team', 'Validation', 'pass')}}}],
    'scenarios/generate.yaml': [{
        'input': {'policy': 'policies/ns-quota.yaml',
                  'resource': 'resources/namespace.yaml'},
        'expected': {'generation': {'generatedResources': [
            {'apiVersion': 'v1', 'kind': 'ConfigMap',
             'name': 'defaults'}]}}}],
    # expectations the engine does not meet: both runners must fail alike
    'scenarios/wrong-status.yaml': [{
        'input': {'policy': 'policies/require-team.yaml',
                  'resource': 'resources/pod.yaml'},
        'expected': {'validation': {'policyresponse': _rules(
            'require-team', 'check-team', 'Validation', 'pass')}}}],
    'scenarios/wrong-generate.yaml': [{
        'input': {'policy': 'policies/ns-quota.yaml',
                  'resource': 'resources/namespace.yaml'},
        'expected': {'generation': {'generatedResources': [
            {'apiVersion': 'v1', 'kind': 'ConfigMap',
             'name': 'missing'}]}}}],
}


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    for rel, doc in list(_FILES.items()) + list(_SCENARIOS.items()):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(yaml.safe_dump(doc) if isinstance(doc, dict)
                        else yaml.safe_dump_all(doc))
    monkeypatch.setattr(jax_scenarios, 'REF_ROOT', str(tmp_path))
    monkeypatch.setattr(port_scenarios, 'REF_ROOT', str(tmp_path))
    return tmp_path


def _outcome(runner, rel):
    try:
        return ('ok', runner.run_scenario(rel))
    except AssertionError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize('rel', sorted(_SCENARIOS))
def test_scenarios_run_alike(corpus, rel):
    got = _outcome(port_scenarios, rel)
    assert got == _outcome(jax_scenarios, rel)
    if rel.startswith('scenarios/wrong-'):
        assert got[0] == 'ScenarioFailure'
    else:
        assert got == ('ok', len(_SCENARIOS[rel]))


# ---------------------------------------------------------------------------
# kuttl: chip_smoke.py's suite through both harnesses


def _kuttl_outcome(run):
    try:
        run()
        return 'passed'
    except AssertionError as e:
        return f'{type(e).__name__}: {str(e).split(";")[0]}'


@pytest.fixture
def kuttl_env(tmp_path, monkeypatch):
    monkeypatch.setenv('KTPU_AOT', '0')
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')   # no fork under threads
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))
    yield tmp_path
    from kyverno_tpu.observability import provenance as jp
    from kyverno_tpu_torch.observability import provenance as pp
    jp.disable()
    pp.disable()


@pytest.mark.parametrize('failing', [False, True], ids=['passes', 'fails'])
def test_kuttl_suite_runs_alike(kuttl_env, failing):
    suite = chip_smoke.write_kuttl_suite(str(kuttl_env / 'suite'),
                                         failing=failing)
    port = _kuttl_outcome(lambda: port_kuttl.run_suite(suite, device='cpu'))
    with x64_shim():
        ref = _kuttl_outcome(lambda: jax_kuttl.run_suite(suite))
    assert port.split(':')[0] == ref.split(':')[0]
    if failing:
        assert port.startswith('KuttlFailure: no live PolicyReport')
        assert ref.startswith('KuttlFailure: no live PolicyReport')
    else:
        assert port == ref == 'passed'


def test_kuttl_denied_pod_applied_cleanly_fails_alike(kuttl_env):
    """A suite whose plain ``kubectl apply`` names the denied Pod must
    raise ``KuttlFailure`` (denied unexpectedly) in both harnesses."""
    suite = chip_smoke.write_kuttl_suite(str(kuttl_env / 'suite'))
    with open(os.path.join(suite, '02-script.yaml'), 'w') as f:
        f.write(yaml.safe_dump({
            'apiVersion': 'kuttl.dev/v1beta1', 'kind': 'TestStep',
            'commands': [{'script': 'kubectl apply -f pod-bad.yaml'}]}))
    outcomes = [_kuttl_outcome(
        lambda: port_kuttl.run_suite(suite, device='cpu'))]
    with x64_shim():
        outcomes.append(_kuttl_outcome(lambda: jax_kuttl.run_suite(suite)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0].startswith('KuttlFailure: pod-bad.yaml denied '
                                  'unexpectedly')


def test_kuttl_cluster_takes_the_device(kuttl_env):
    """``KuttlCluster(device=...)`` hands the device to the admission
    and reports daemons: their scanners are built on it."""
    import torch
    cluster = port_kuttl.KuttlCluster(device='cpu')
    try:
        assert cluster.admission.handlers.torch_device == torch.device('cpu')
        assert torch.device(cluster.reports.scan_controller.device) == \
            torch.device('cpu')
    finally:
        cluster.close()
