"""The port's device mutate (``kyverno_tpu_torch/mutate/``) against the
JAX package's, and both against the host engine's mutate chain.

* K3's plain version (``ops/kernels.py k3_mutate_plain``) against the JAX
  ``MutateKernel`` on the kernel cases of ``tests/test_device_mutate.py``
  and on numpy-seeded random lanes (32-site rules, so bit 31 is set;
  windows of 8 and 256 bytes; padding rows; a program with no sites).
  The three outputs must be equal, element for element.
* The site tables the port's ``MutateKernel`` builds equal the JAX
  kernel's (the state carried across).
* The port's ``MutateScanner`` (on the CPU) against the JAX one and the
  host chain, on the mutate pack over 256 seeded Pods.
* The wrapper takes the plain version for CPU tensors, counts no
  launch, and checks its inputs.

The JAX kernel runs under ``x64_shim`` (``tests/test_torch_reference.py``),
scoped to each call.
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kyverno_tpu.api.policy import Policy as JaxPolicy
from kyverno_tpu.compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT,
                                     TAG_INT, TAG_MAP, TAG_MISSING,
                                     TAG_NULL, TAG_STRING)
from kyverno_tpu.mutate import MutateScanner as JaxMutateScanner
from kyverno_tpu.mutate import compile_mutate_set as jax_compile_set
from kyverno_tpu.mutate.encode import encode_mutate_batch as jax_encode
from kyverno_tpu.mutate.kernel import MutateKernel as JaxMutateKernel
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.mutate import MutateScanner, compile_mutate_set
from kyverno_tpu_torch.mutate.encode import encode_mutate_batch
from kyverno_tpu_torch.mutate.kernel import (MUT_FALLBACK, MUT_PASS,
                                             MUT_SKIP, MutateKernel)
from kyverno_tpu_torch.mutate.plan import EditSite
from kyverno_tpu_torch.ops import kernels
from test_torch_reference import x64_shim

ALL_TAGS = (TAG_MISSING, TAG_NULL, TAG_BOOL, TAG_INT, TAG_FLOAT,
            TAG_STRING, TAG_MAP, TAG_ARRAY)
INT64_MAX = (1 << 63) - 1


def jax_kernel_out(program, lanes):
    with x64_shim():
        return JaxMutateKernel(program)(lanes)


def port_kernel_out(program, lanes):
    return MutateKernel(program, 'cpu')(lanes)


def assert_outputs_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the kernel cases of tests/test_device_mutate.py


def policy(name, rule):
    return {'apiVersion': 'kyverno.io/v1', 'kind': 'ClusterPolicy',
            'metadata': {'name': name}, 'spec': {'rules': [rule]}}


def sm_policy(name, overlay):
    return policy(name, {
        'name': 'r', 'match': {'any': [{'resources': {'kinds': ['Pod']}}]},
        'mutate': {'patchStrategicMerge': overlay}})


def j6_policy(name, ops):
    return policy(name, {
        'name': 'r', 'match': {'any': [{'resources': {'kinds': ['Pod']}}]},
        'mutate': {'patchesJson6902': json.dumps(ops)}})


def pod(i=0, **over):
    doc = {'apiVersion': 'v1', 'kind': 'Pod',
           'metadata': {'name': f'p{i}', 'namespace': 'default'},
           'spec': {'containers': [{'name': 'c', 'image': 'nginx'}]}}
    doc.update(over)
    return doc


KERNEL_CASES = {
    'missing_leaf_applies': (
        sm_policy('p', {'spec': {'dnsPolicy': 'ClusterFirst'}}), pod(),
        (MUT_PASS, 1)),
    'equal_value_skips': (
        sm_policy('p', {'spec': {'dnsPolicy': 'ClusterFirst'}}),
        pod(spec={'dnsPolicy': 'ClusterFirst'}), (MUT_SKIP, 0)),
    'add_only_skips_present': (
        sm_policy('p', {'metadata': {'labels': {'+(t)': 'x'}}}),
        pod(metadata={'name': 'p', 'labels': {'t': 'other'}}),
        (MUT_SKIP, 0)),
    'non_map_intermediate_falls_back': (
        sm_policy('p', {'spec': {'a': {'b': 'x'}}}),
        pod(spec={'a': 'not-a-map'}), (MUT_FALLBACK, None)),
    'replace_missing_falls_back': (
        j6_policy('p', [{'op': 'replace', 'path': '/spec/tier',
                         'value': 'gold'}]), pod(), (MUT_FALLBACK, None)),
    'numeric_outside_milli_window_undecidable': (
        sm_policy('p', {'spec': {'replicas': 3}}),
        pod(spec={'replicas': 1e300}), (MUT_FALLBACK, None)),
}


@pytest.mark.parametrize('case', sorted(KERNEL_CASES))
def test_kernel_cases_match_jax(case):
    pol, doc, (want_status, want_edits) = KERNEL_CASES[case]
    jprog = jax_compile_set([JaxPolicy(json.loads(json.dumps(pol)))])
    pprog = compile_mutate_set([Policy(json.loads(json.dumps(pol)))])
    assert jprog.device_ok and pprog.device_ok
    lanes = encode_mutate_batch([doc], pprog)
    jl = jax_encode([doc], jprog)
    for k in lanes:
        np.testing.assert_array_equal(lanes[k], jl[k])
    got = port_kernel_out(pprog, lanes)
    assert_outputs_equal(got, jax_kernel_out(jprog, jl))
    assert int(got[0][0, 0]) == want_status
    if want_edits is not None:
        assert int(got[1][0, 0]) == want_edits
    if want_status == MUT_FALLBACK:
        assert int(got[2][0, 0]) != 0


# ---------------------------------------------------------------------------
# seeded random lanes


def random_program(rng, n_rules, sites_per_rule, w):
    """A program of ``n_rules`` rules with the given site counts (both
    packages' kernels read only ``programs[i].sites``).  String constants
    fill up to ``w`` bytes, so ``string_window`` is ``w``; at the 256-byte
    cap some pass it, and only their first 256 bytes are compared."""
    alphabet = b'abcxyz-_.:/0123456789'
    programs = []
    for r in range(n_rules):
        sites = []
        for k in range(sites_per_rule[r]):
            kind = rng.integers(0, 5)
            if kind == 0:
                value = bool(rng.integers(0, 2))
            elif kind == 1:
                value = int(rng.choice([0, 1, -7, 3, INT64_MAX // 1000]))
            elif kind == 2:
                value = float(rng.choice([0.25, -1.5, 2.0]))
            else:
                n = int(rng.choice([0, 1, w - 1, w, w,
                                    w + 9 if w == 256 else w]))
                value = bytes(rng.choice(np.frombuffer(alphabet, np.uint8),
                                         max(n, 0))).decode()
            sites.append(EditSite(path=('spec', f'f{r}_{k}'),
                                  add_only=bool(rng.random() < 0.3),
                                  value=value,
                                  replace=bool(rng.random() < 0.2)))
        programs.append(SimpleNamespace(sites=sites))
    # string_window sizes the lane to the longest constant, capped at 256
    programs[0].sites[0] = EditSite(path=('spec', 'wide'), add_only=False,
                                    value='w' * w, replace=False)
    return SimpleNamespace(programs=programs)


def random_lanes(rng, kernel, rows, pad_frac=0.1):
    """Lanes that hit every branch: values equal to the site constants
    (numbers at the milli window's edges, strings with their bytes), one
    byte or one length off, every tag, every intermediate state."""
    s, w = kernel.n_sites, kernel.width
    tag = rng.choice(np.array(ALL_TAGS + (TAG_STRING, TAG_INT), np.int8),
                     (rows, s))
    istate = rng.choice(np.array([0, 0, 0, 1, 2], np.int8), (rows, s))
    edges = np.array([0, 1000, -1000, INT64_MAX, -INT64_MAX - 1, 250],
                     np.int64)
    milli = np.where(rng.random((rows, s)) < 0.6,
                     kernel._t_milli[None, :],
                     rng.choice(edges, (rows, s))).astype(np.int64)
    milli_ok = rng.random((rows, s)) < 0.8
    slen = np.where(rng.random((rows, s)) < 0.7, kernel._t_len[None, :],
                    kernel._t_len[None, :] + rng.integers(-1, 2, (rows, s))
                    ).astype(np.int32)
    sbytes = np.broadcast_to(kernel._t_bytes, (rows, s, w)).copy()
    flip = rng.random((rows, s)) < 0.2
    pos = rng.integers(0, w, (rows, s))
    r_i, s_i = np.nonzero(flip)
    sbytes[r_i, s_i, pos[r_i, s_i]] ^= rng.integers(
        1, 256, len(r_i)).astype(np.uint8)
    valid = np.arange(rows) < rows - int(rows * pad_frac)
    return {'tag': tag, 'istate': istate, 'milli': milli,
            'milli_ok': milli_ok, 'slen': slen, 'sbytes': sbytes,
            'valid': valid}


@pytest.mark.parametrize('w', [8, 256])
@pytest.mark.parametrize('seed', [0, 1])
def test_random_lanes_match_jax(w, seed):
    rng = np.random.default_rng(seed)
    counts = [32, 1, 32, 5, 32, 0, 17, 32]
    prog = random_program(rng, 8, counts, w)
    kernel = MutateKernel(prog, 'cpu')
    assert kernel.width == w and kernel.n_sites == sum(counts)
    lanes = random_lanes(np.random.default_rng(seed + 10), kernel, 200)
    got = kernel(lanes)
    want = jax_kernel_out(prog, lanes)
    assert_outputs_equal(got, want)
    status, edits, _reason = got
    # every branch was reached, bit 31 among the edit masks
    assert {MUT_SKIP, MUT_PASS, MUT_FALLBACK} <= set(np.unique(status))
    assert ((edits >> 31) & 1).any()
    assert not status[~lanes['valid']].any()
    assert not edits[~lanes['valid']].any()


def test_no_sites_returns_zeros():
    prog = SimpleNamespace(programs=[SimpleNamespace(sites=[]),
                                     SimpleNamespace(sites=[])])
    lanes = random_lanes(np.random.default_rng(3),
                         MutateKernel(prog, 'cpu'), 9)
    got = port_kernel_out(prog, lanes)
    assert_outputs_equal(got, jax_kernel_out(prog, lanes))
    assert [o.shape for o in got] == [(9, 2)] * 3 and not any(
        o.any() for o in got)
    # the wrapper's plain version gives the same zeros
    t = MutateKernel(prog, 'cpu')
    plain = kernels.k3_mutate_plain(t.stage(lanes), t.site_tensors())
    assert_outputs_equal([o.numpy() for o in plain], got)


# ---------------------------------------------------------------------------
# the state carried across: the site tables


@pytest.mark.parametrize('w', [8, 256])
def test_site_tables_equal_jax(w):
    prog = random_program(np.random.default_rng(5), 4, [3, 32, 0, 7], w)
    jk = JaxMutateKernel(prog)
    pk = MutateKernel(prog, 'cpu')
    for name in ('_t_is_num', '_t_milli', '_t_len', '_t_bytes',
                 '_add_only', '_replace'):
        a, b = getattr(pk, name), getattr(jk, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (pk.n_rules, pk.n_sites, pk.width) == \
        (jk.n_rules, jk.n_sites, jk.width)
    # CSR offsets: the cumulative site count of the site-to-rule one-hot
    offsets = np.concatenate([[0], np.cumsum(jk._onehot.sum(axis=0))])
    np.testing.assert_array_equal(pk._rule_start, offsets)
    site_rule = np.repeat(np.arange(pk.n_rules), np.diff(pk._rule_start))
    bit = np.arange(pk.n_sites) - pk._rule_start[site_rule]
    np.testing.assert_array_equal(np.int64(1) << bit.astype(np.int64),
                                  jk._bit_w)
    tables = pk.site_tensors()
    assert tables['rule_start'].dtype == torch.int32
    assert all(t.device.type == 'cpu' for t in tables.values())


# ---------------------------------------------------------------------------
# the scanner: the mutate pack over 256 Pods


def test_scanner_matches_jax_and_host_chain():
    import yaml
    docs = [d for d in yaml.safe_load_all(smokepack.MUTATE_PACK) if d]
    policies = [Policy(json.loads(json.dumps(d))) for d in docs]
    jpolicies = [JaxPolicy(json.loads(json.dumps(d))) for d in docs]
    rng = random.Random(7)
    pods = [smokepack.make_mutate_pod(rng, i) for i in range(256)]

    scanner = MutateScanner(policies, device='cpu')
    assert scanner.ok and scanner.device == torch.device('cpu')
    rows = scanner.scan([json.loads(json.dumps(p)) for p in pods])
    with x64_shim():
        jrows = JaxMutateScanner(jpolicies).scan(
            [json.loads(json.dumps(p)) for p in pods])
    fallback = 0
    for i, p in enumerate(pods):
        key = smokepack.mutate_row_key(*rows[i])
        assert key == smokepack.mutate_row_key(*jrows[i]), i
        assert key == smokepack.mutate_row_key(
            *smokepack.host_mutate_chain(policies, p)), i
        fallback += 'tier' not in p['metadata']['annotations']
    # the pack sends the Pods without a tier annotation to FALLBACK
    assert 10 <= fallback <= 50


def test_scanner_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        MutateScanner(smokepack.load_mutate_pack())


# ---------------------------------------------------------------------------
# the wrapper


def _small():
    prog = random_program(np.random.default_rng(2), 2, [4, 3], 8)
    k = MutateKernel(prog, 'cpu')
    return k, k.stage(random_lanes(np.random.default_rng(4), k, 6))


def test_cpu_wrapper_takes_plain_and_counts_nothing():
    k, lanes = _small()
    kernels.reset_launches()
    got = kernels.k3_mutate(lanes, k.site_tensors())
    want = kernels.k3_mutate_plain(lanes, k.site_tensors())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES['k3_mutate'] == 0


@pytest.mark.parametrize('fault', ['tag_dtype', 'milli_shape', 'sbytes_rank',
                                   'valid_len', 't_bytes_width',
                                   'rule_start_dtype', 'mixed_devices',
                                   'rule_over_32_sites', 'rule_start_short'])
def test_wrapper_checks(fault):
    k, lanes = _small()
    if fault == 'rule_over_32_sites':
        # one warp lane per site: a rule of 33 sites is refused
        k = MutateKernel(random_program(np.random.default_rng(2), 2,
                                        [17, 16], 8), 'cpu')
        lanes = k.stage(random_lanes(np.random.default_rng(4), k, 6))
    sites = dict(k.site_tensors())
    lanes = dict(lanes)
    if fault == 'rule_over_32_sites':
        sites['rule_start'] = torch.tensor([0, 33, 33], dtype=torch.int32)
    elif fault == 'rule_start_short':
        sites['rule_start'] = sites['rule_start'].clone()
        sites['rule_start'][-1] -= 1
    elif fault == 'tag_dtype':
        lanes['tag'] = lanes['tag'].to(torch.int32)
    elif fault == 'milli_shape':
        lanes['milli'] = lanes['milli'][:, :-1]
    elif fault == 'sbytes_rank':
        lanes['sbytes'] = lanes['sbytes'][:, :, 0]
    elif fault == 'valid_len':
        lanes['valid'] = lanes['valid'][:-1]
    elif fault == 't_bytes_width':
        sites['t_bytes'] = torch.zeros((k.n_sites, 16), dtype=torch.uint8)
    elif fault == 'rule_start_dtype':
        sites['rule_start'] = sites['rule_start'].long()
    elif fault == 'mixed_devices':
        lanes['tag'] = lanes['tag'].to('meta')
    with pytest.raises(ValueError):
        kernels.k3_mutate(lanes, sites)
