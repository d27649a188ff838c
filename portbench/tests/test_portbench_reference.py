"""The plain reference agrees with the program's host engine, the
program's own oracle, on the benchmark's traffic."""

import os

import pytest

from portbench import gen, reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _policies(packs):
    import yaml
    from kyverno_tpu_torch.api.policy import Policy
    docs = []
    for pack in packs:
        with open(os.path.join(ROOT, 'portbench', 'packs',
                               pack + '.yaml')) as f:
            docs += [d for d in yaml.safe_load_all(f) if d]
    return [Policy(d) for d in docs]


@pytest.mark.parametrize('seed', [2**31 + 3, 2**33 + 1])
def test_report_rows_match_the_host_engine(seed):
    from kyverno_tpu_torch import smokepack
    packs = ['best_practice', 'jmespath', 'pss']
    policies = _policies(packs)
    rules = reference.pack_rules(packs)
    for pod in gen.scan_pods('config4', 400, seed):
        want = smokepack.host_report_results(policies, pod, now=5)
        assert reference.report_rows(rules, pod, 5) == (want[0], want[1])
