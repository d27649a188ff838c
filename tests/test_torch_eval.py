"""The port's evaluator (``kyverno_tpu_torch/ops/eval.py``, on the CPU
with the kernels' plain versions) against the JAX evaluator: the same
policies over the same seeded resources must encode to the same packed
buffers and evaluate to byte-equal compact outputs (``out8``: statuses,
details and admission columns; ``out32``: the first-K fail-detail
columns and their details).  Every output is an integer, so the
comparison is exact.

Each pack is evaluated at one padded capacity (128 rows) for 1, 63, 64
and 65 live rows, so the JAX reference compiles once per pack; the port
also runs each count at its canonical capacity (64 rows up to 64 live
rows), whose live rows must equal the padded run's.
"""

import numpy as np
import pytest
import torch

from test_torch_reference import PACKS, jax_reference, load_pack, make_resources  # noqa: F401

ROW_COUNTS = (1, 63, 64, 65)
CAP = 128

_EVALUATORS = {}


def _evaluators(name):
    """(JAX cps, JAX evaluator, port cps, port evaluator), one per pack
    for the whole module."""
    if name not in _EVALUATORS:
        from kyverno_tpu.compiler.compile import compile_policies as jcomp
        from kyverno_tpu.ops.eval import build_evaluator as jbuild
        from kyverno_tpu_torch.compiler.compile import \
            compile_policies as tcomp
        from kyverno_tpu_torch.ops.eval import build_evaluator as tbuild
        jpols, tpols = load_pack(name)
        jc, tc = jcomp(jpols), tcomp(tpols)
        _EVALUATORS[name] = (jc, jbuild(jc), tc, tbuild(tc, 'cpu'))
    return _EVALUATORS[name]


def _tensors(encode, zero_lanes, cps, evaluator, docs, cap, match):
    tensors = dict(encode(docs, cps, padded_n=cap).tensors())
    tensors['__match__'] = match[:cap]
    if evaluator.adm_table is not None:
        tensors.update(zero_lanes(evaluator.adm_table, cap))
    return tensors


def _run_jax(jev, tensors):
    from kyverno_tpu.ops.eval import shard_batch
    packed, layout = shard_batch(tensors)
    out8, out32 = jev(packed, layout)
    return np.array(out8), np.array(out32)


def _run_torch(tev, tensors):
    from kyverno_tpu_torch.ops.eval import shard_batch
    packed, layout = shard_batch(tensors, 'cpu')
    out8, out32 = tev(packed, layout)
    return out8.numpy(), out32.numpy()


@pytest.mark.parametrize('n', ROW_COUNTS)
@pytest.mark.parametrize('name', sorted(PACKS))
def test_out8_out32_byte_equal(name, n, jax_reference):
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu.ops.eval import pack_batch as jpack
    from kyverno_tpu_torch.compiler import admission as tadm
    from kyverno_tpu_torch.compiler.encode import encode_batch as tencode
    from kyverno_tpu_torch.ops.eval import pack_batch as tpack
    jc, jev, tc, tev = _evaluators(name)
    assert jev.n_uniq == tev.n_uniq and jev.n_cols_u == tev.n_cols_u
    docs = make_resources(name, max(ROW_COUNTS))[:n]
    rng = np.random.default_rng(n)
    match = (rng.random((CAP, tev.n_uniq)) < 0.85).astype(np.uint8)

    jt = _tensors(jencode, jadm.zero_lanes, jc, jev, docs, CAP, match)
    tt = _tensors(tencode, tadm.zero_lanes, tc, tev, docs, CAP, match)
    # the copied encoder: identical packed buffers and layout
    jpacked, jlayout = jpack(jt)
    tpacked, tlayout = tpack(tt)
    assert jlayout == tlayout
    assert sorted(jpacked) == sorted(tpacked)
    for k in jpacked:
        assert jpacked[k].dtype == tpacked[k].dtype, k
        assert np.array_equal(jpacked[k], tpacked[k]), k

    j8, j32 = _run_jax(jev, jt)
    t8, t32 = _run_torch(tev, tt)
    assert (t8.dtype, t32.dtype) == (np.int8, np.int32)
    assert t8.shape == j8.shape and t32.shape == j32.shape
    assert t8.tobytes() == j8.tobytes()
    assert t32.tobytes() == j32.tobytes()

    # the port at the canonical capacity agrees on every live row
    cap = 64 if n <= 64 else CAP
    if cap != CAP:
        ct = _tensors(tencode, tadm.zero_lanes, tc, tev, docs, cap, match)
        c8, c32 = _run_torch(tev, ct)
        assert c8[:n].tobytes() == j8[:n].tobytes()
        assert c32[:n].tobytes() == j32[:n].tobytes()


def test_smoke_pack_compiles_fully_and_reaches_wildcard_dp(monkeypatch):
    """The smoke pack's device programs: 13, no host rules, and the
    ``*:*`` glob reaches the K1c wildcard kernel's wrapper."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import shard_batch
    _jc, _jev, tc, tev = _evaluators('smoke')
    assert len(tc.programs) == 13 and tc.host_rules == []
    seen = []
    real = kernels.wildcard_match

    def spy(head, str_len, tag, pattern):
        seen.append(pattern)
        return real(head, str_len, tag, pattern)
    monkeypatch.setattr(kernels, 'wildcard_match', spy)
    docs = make_resources('smoke', 8)
    tensors = dict(encode_batch(docs, tc, padded_n=64).tensors())
    tensors['__match__'] = np.ones((64, tev.n_uniq), np.uint8)
    packed, layout = shard_batch(tensors, 'cpu')
    tev(packed, layout)
    assert b'*:*' in seen


def test_build_evaluator_defaults_to_cuda(monkeypatch):
    from kyverno_tpu_torch.ops.eval import build_evaluator
    jc, _jev, tc, _tev = _evaluators('smoke')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_evaluator(tc)
