"""The port's CLI (``kyverno_tpu_torch.cli``) against the JAX package's:
both run the host ``Engine`` only, so every command must print the same
bytes and exit with the same code.  Each case runs through both
packages' ``cli.main.main`` on the same files under ``tmp_path``."""

import json
import os
import random
import subprocess
import sys

import pytest
import yaml

from kyverno_tpu.cli import main as jax_cli
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.cli import main as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_clock(monkeypatch):
    """Both packages stamp report results with ``time.time()``: hold
    them to one second, so a run that crosses a second prints the
    same bytes."""
    import time
    now = time.time()
    monkeypatch.setattr(time, 'time', lambda: now)


def _both(capsys, argv):
    """``(exit code, stdout)`` of each package's ``main(argv)``."""
    out = []
    for cli in (jax_cli, port_cli):
        rc = cli.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def _same(capsys, argv):
    (jrc, jout), (prc, pout) = _both(capsys, argv)
    assert (prc, pout) == (jrc, jout)
    return prc, pout


@pytest.fixture
def cluster(tmp_path):
    """The smoke pack as one YAML file and 50 seeded Pods as another."""
    pol = tmp_path / 'smoke.yaml'
    pol.write_text(smokepack.SMOKE_PACK)
    rng = random.Random(12)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(50)]
    res = tmp_path / 'pods.yaml'
    res.write_text(yaml.safe_dump_all(pods))
    return pol, res


@pytest.mark.parametrize('flags', [(), ('--policy-report',),
                                   ('--audit-warn',),
                                   ('--policy-report', '--audit-warn')],
                         ids=['plain', 'policy-report', 'audit-warn',
                              'report-audit-warn'])
def test_apply_smoke_pack(capsys, cluster, flags):
    pol, res = cluster
    rc, out = _same(capsys, ['apply', str(pol), '--resource', str(res),
                             *flags])
    assert out.strip()
    if '--policy-report' in flags:
        assert 'PolicyReport' in out or 'summary' in out


def test_apply_enforce_pack_fails(capsys, tmp_path, cluster):
    """The pack in Enforce over the same Pods: failures set the exit
    code, in both packages alike."""
    _pol, res = cluster
    docs = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    for d in docs:
        d['spec']['validationFailureAction'] = 'Enforce'
    pol = tmp_path / 'enforce.yaml'
    pol.write_text(yaml.safe_dump_all(docs))
    rc, _out = _same(capsys, ['apply', str(pol), '--resource', str(res)])
    assert rc != 0


_TEST_POLICY = '''apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: require-team
spec:
  validationFailureAction: Audit
  background: true
  rules:
    - name: check-team
      match:
        any:
          - resources:
              kinds: [Pod]
      exclude:
        any:
          - resources:
              namespaces: [kube-system]
      validate:
        message: "label 'team' is required"
        pattern:
          metadata:
            labels:
              team: "?*"
    - name: no-latest
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "an image tag is required"
        pattern:
          spec:
            containers:
              - image: "!*:latest"
'''


def _pod(name, ns, labels, image):
    return {'apiVersion': 'v1', 'kind': 'Pod',
            'metadata': {'name': name, 'namespace': ns, 'labels': labels},
            'spec': {'containers': [{'name': 'c', 'image': image}]}}


@pytest.fixture
def test_dir(tmp_path):
    """A kyverno-test.yaml directory whose expectations hold a pass, a
    fail, a skip (an excluded namespace) and one expectation that is
    wrong, so the run fails."""
    d = tmp_path / 'suite'
    d.mkdir()
    (d / 'policy.yaml').write_text(_TEST_POLICY)
    pods = [_pod('good', 'default', {'team': 'a'}, 'nginx:1.25'),
            _pod('bad', 'default', {}, 'nginx:latest'),
            _pod('system', 'kube-system', {}, 'nginx:1.25')]
    (d / 'resources.yaml').write_text(yaml.safe_dump_all(pods))
    results = [
        {'policy': 'require-team', 'rule': 'check-team',
         'resource': 'good', 'kind': 'Pod', 'result': 'pass'},
        {'policy': 'require-team', 'rule': 'check-team',
         'resource': 'bad', 'kind': 'Pod', 'result': 'fail'},
        {'policy': 'require-team', 'rule': 'check-team',
         'resource': 'system', 'kind': 'Pod', 'result': 'skip'},
        {'policy': 'require-team', 'rule': 'no-latest',
         'resource': 'bad', 'kind': 'Pod', 'result': 'fail'},
        {'policy': 'require-team', 'rule': 'no-latest',
         'resource': 'good', 'kind': 'Pod', 'result': 'fail'},
    ]
    (d / 'kyverno-test.yaml').write_text(yaml.safe_dump({
        'name': 'require-team', 'policies': ['policy.yaml'],
        'resources': ['resources.yaml'], 'results': results}))
    return d


@pytest.mark.parametrize('extra', [(), ('--fail-only',),
                                   ('--test-case-selector',
                                    'policy=require-team,rule=check-team'),
                                   ('--test-case-selector',
                                    'rule=no-latest,resource=bad')],
                         ids=['all', 'fail-only', 'selector-rule',
                              'selector-resource'])
def test_test_command(capsys, test_dir, extra):
    rc, out = _same(capsys, ['test', str(test_dir), *extra])
    assert out.strip()
    if extra and extra[0] == '--test-case-selector' and \
            'check-team' in extra[1]:
        assert rc == 0          # the wrong expectation is filtered out
    elif not extra or extra[0] == '--fail-only':
        assert rc != 0


@pytest.mark.parametrize('query', [
    'spec.containers[*].image', 'length(spec.containers)',
    "to_upper(metadata.name)", 'metadata.labels.team'])
def test_jp_query(capsys, tmp_path, query):
    doc = _pod('web', 'default', {'team': 'a'}, 'nginx:1.25')
    doc['spec']['containers'].append({'name': 'side', 'image': 'envoy:1'})
    inp = tmp_path / 'in.json'
    inp.write_text(json.dumps(doc))
    rc, out = _same(capsys, ['jp', 'query', '--input', str(inp), query])
    assert rc == 0 and out.strip()


def test_jp_parse_and_functions(capsys):
    _same(capsys, ['jp', 'parse', 'a.b[?c == `1`].d'])
    _same(capsys, ['jp', 'function'])


def test_oci_push_pull(capsys, tmp_path):
    """Each package pushes the smoke pack to a layout of its own and
    pulls it back: same output, same pulled policies."""
    pol = tmp_path / 'smoke.yaml'
    pol.write_text(smokepack.SMOKE_PACK)
    outs = []
    for name, cli in (('jax', jax_cli), ('port', port_cli)):
        layout = tmp_path / name / 'layout'
        pulled = tmp_path / name / 'pulled'
        rc_push = cli.main(['oci', 'push', str(pol), '--image',
                            f'{layout}:v1'])
        push_out = capsys.readouterr().out.replace(str(tmp_path / name),
                                                   '<dir>')
        rc_pull = cli.main(['oci', 'pull', '--image', f'{layout}:v1',
                            '--output', str(pulled)])
        pull_out = capsys.readouterr().out.replace(str(tmp_path / name),
                                                   '<dir>')
        files = {f: (pulled / f).read_text()
                 for f in sorted(os.listdir(pulled))}
        outs.append((rc_push, push_out, rc_pull, pull_out, files))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0 and outs[1][2] == 0 and outs[1][4]


def test_version_and_module_entry_point():
    """``python -m kyverno_tpu_torch.cli version`` runs the port's CLI
    and prints the port's version."""
    from kyverno_tpu_torch import __version__
    proc = subprocess.run([sys.executable, '-m', 'kyverno_tpu_torch.cli',
                           'version'], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f'Version: {__version__}'
