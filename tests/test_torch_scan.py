"""The port's validate scan end to end on the CPU: ``BatchScanner``'s
``scan_report_results`` and ``scan`` against the JAX package's scanner
(under the x64 shim) and against the host ``Engine`` alone, over the
smoke pack with a small chunk so that several chunks stream through the
encode → h2d → device_eval → d2h pipeline."""

import pytest

from test_torch_reference import jax_reference, load_pack, make_resources  # noqa: F401

N_PODS = 200
CHUNK = 64
NOW = 1_700_000_000


def _port_scanner(policies, procs=0, chunk=CHUNK):
    import os
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    old = os.environ.get('KTPU_ENCODE_PROCS')
    os.environ['KTPU_ENCODE_PROCS'] = str(procs)
    try:
        sc = BatchScanner(policies, device='cpu')
    finally:
        if old is None:
            del os.environ['KTPU_ENCODE_PROCS']
        else:
            os.environ['KTPU_ENCODE_PROCS'] = old
    sc.CHUNK = chunk
    sc.ENCODE_TIMEOUT_S = 30.0
    return sc


def _host_rows(jax_policies, pods):
    """Report rows from the JAX package's host engine alone."""
    from kyverno_tpu.engine.api import PolicyContext
    from kyverno_tpu.engine.engine import Engine
    from kyverno_tpu.reports.results import (
        calculate_summary, engine_response_to_report_results,
        sort_report_results)
    engine = Engine()
    rows = []
    for pod in pods:
        results = []
        for policy in jax_policies:
            resp = engine.apply_background_checks(
                PolicyContext(policy, new_resource=pod))
            if resp.policy_response.rules:
                results.extend(
                    engine_response_to_report_results(resp, now=NOW))
        sort_report_results(results)
        rows.append((results, calculate_summary(results)))
    return rows


def _rule_table(responses):
    out = {}
    for resp in responses:
        if resp.policy_response.rules:
            out[resp.policy_response.policy_name] = {
                r.name: (str(r.status), r.message)
                for r in resp.policy_response.rules}
    return out


def test_scan_report_results_matches_jax_and_host(jax_reference):
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    jpols, tpols = load_pack('smoke')
    pods = make_resources('smoke', N_PODS, seed=11)
    port = [(r, s, [p.name for p in ps]) for r, s, ps in
            _port_scanner(tpols).scan_report_results(pods, now=NOW)]
    jsc = JaxScanner(jpols)
    jsc.CHUNK = CHUNK
    jsc._encoder_pool.procs = 0  # no fork of a process holding jax
    ref = [(r, s, [p.name for p in ps]) for r, s, ps in
           jsc.scan_report_results(pods, now=NOW)]
    assert len(port) == len(ref) == N_PODS
    assert port == ref
    host = _host_rows(jpols, pods)
    for i, ((results, summary, _pols), (h_results, h_summary)) in \
            enumerate(zip(port, host)):
        assert summary == h_summary, i
        assert results == h_results, i


def test_scan_matches_jax_and_host(jax_reference):
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    from kyverno_tpu.engine.api import PolicyContext
    from kyverno_tpu.engine.engine import Engine
    jpols, tpols = load_pack('smoke')
    pods = make_resources('smoke', 150, seed=12)
    port = _port_scanner(tpols).scan(pods)
    jsc = JaxScanner(jpols)
    jsc.CHUNK = CHUNK
    jsc._encoder_pool.procs = 0  # no fork of a process holding jax
    ref = jsc.scan(pods)
    engine = Engine()
    for i, pod in enumerate(pods):
        host = _rule_table(
            engine.apply_background_checks(
                PolicyContext(p, new_resource=pod)) for p in jpols)
        assert _rule_table(port[i]) == _rule_table(ref[i]) == host, i


@pytest.mark.parametrize('name', ['compiler', 'conditions', 'foreach'])
def test_scan_other_packs_match_host(name):
    """Packs with deployments, conditions and foreach: every row of the
    port's scan equals the host engine's."""
    from kyverno_tpu_torch.engine.api import PolicyContext
    from kyverno_tpu_torch.engine.engine import Engine
    _jpols, tpols = load_pack(name)
    docs = make_resources(name, 100, seed=5)
    rows = _port_scanner(tpols).scan(docs)
    engine = Engine()
    for i, doc in enumerate(docs):
        host = _rule_table(
            engine.apply_background_checks(
                PolicyContext(p, new_resource=doc)) for p in tpols)
        assert _rule_table(rows[i]) == host, i


_POOL_CHILD = r'''
import os, random, sys
sys.path.insert(0, sys.argv[1])
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.compiler.scan import BatchScanner
policies = smokepack.load_smoke_pack()
rng = random.Random(13)
pods = [smokepack.make_config4_pod(rng, i) for i in range(3 * 64 + 5)]
rows = {}
for procs in ('2', '0'):
    os.environ['KTPU_ENCODE_PROCS'] = procs
    sc = BatchScanner(policies, device='cpu')
    sc.CHUNK = 64
    sc.ENCODE_TIMEOUT_S = 60.0
    rows[procs] = [(r, s) for r, s, _p in
                   sc.scan_report_results(pods, now=1)]
    pool = sc._encoder_pool
    if procs == '2':
        assert pool._pool is not None and not pool._broken
    pool.close()
assert rows['2'] == rows['0'] and len(rows['2']) == len(pods)
print('POOL-OK')
'''


def test_forked_encoder_pool_streams_identically():
    """Multi-chunk scans encode in forked worker processes; their rows
    equal the in-process encoder's.  Run in a fresh interpreter without
    jax, as the port runs in production (forking a process that holds
    jax's threads is not what is under test)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', _POOL_CHILD, root],
                          capture_output=True, text=True, timeout=300,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'POOL-OK' in proc.stdout


def test_admission_rows_match_host_oracle():
    """Per-row admission tuples: the admission match decided on the
    device (``_adm_match_graph``) gives the host engine's responses."""
    import yaml
    import test_admission_lanes as tal
    from kyverno_tpu_torch.api.policy import Policy
    from kyverno_tpu_torch.engine.api import PolicyContext
    policies = [Policy(d) for d in yaml.safe_load_all(tal.POLICIES) if d]
    scanner = _port_scanner(policies)
    assert scanner._adm is not None
    resources = [tal.pod(f'p{i}', {'team': 'x'} if i % 2 else {})
                 for i in range(len(tal.ADMISSIONS))]
    pctxs = {id(doc): PolicyContext(policies[0], new_resource=doc,
                                    admission_info=a[0],
                                    exclude_group_roles=a[1],
                                    admission_operation=a[3])
             for doc, a in zip(resources, tal.ADMISSIONS)}
    rows = scanner.scan(
        resources, contexts=[{'request': {'object': d}} for d in resources],
        admissions=tal.ADMISSIONS, pctx_factory=lambda doc: pctxs[id(doc)])
    jax_pols = [__import__('kyverno_tpu.api.policy', fromlist=['Policy'])
                .Policy(d) for d in yaml.safe_load_all(tal.POLICIES) if d]
    for i, (doc, a) in enumerate(zip(resources, tal.ADMISSIONS)):
        assert tal.sig(rows[i]) == tal.sig(tal.host_oracle(jax_pols, doc, a))


def test_streaming_early_close_releases_pipeline():
    _jpols, tpols = load_pack('smoke')
    pods = make_resources('smoke', 3 * CHUNK, seed=14)
    sc = _port_scanner(tpols)
    stream = sc.scan_report_results(pods, now=NOW)
    first = [next(stream) for _ in range(CHUNK + 3)]
    stream.close()
    assert len(first) == CHUNK + 3
    # the scanner still serves a full scan afterwards
    assert len(list(sc.scan_report_results(pods[:10], now=NOW))) == 10


def test_mesh_scan_stays_monolithic_under_partitions(monkeypatch):
    """A mesh scan is monolithic under ``KTPU_PARTITIONS``, as in the
    reference: it builds no partition runtime."""
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    _jpols, tpols = load_pack('smoke')
    monkeypatch.setenv('KTPU_PARTITIONS', '2')
    mesh = make_mesh(device='cpu')
    sc = BatchScanner(tpols, mesh=mesh, device='cpu')
    assert sc.mesh is mesh and sc._pset is None and sc._composer is None
    monkeypatch.setenv('KTPU_PARTITIONS', '0')
    assert BatchScanner(tpols, mesh=mesh).mesh is mesh


def test_scanner_defaults_to_cuda(monkeypatch):
    import torch
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    _jpols, tpols = load_pack('smoke')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        BatchScanner(tpols)
