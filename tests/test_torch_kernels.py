"""The evaluator's hand-written kernels' plain versions against the JAX
code they replace, on numpy-seeded inputs and the edge cases each must
keep:

* K1h ``fdet_select`` — the tail of the JAX ``evaluate_packed``: the
  relevance of each fail-detail column (FAIL, matched, row valid, the
  ``uniq_any`` children expanded), ``keys = where(rel, col, C)``, per-row
  sort, first k, clamped gather, and the out8 concatenation; the match
  and row-validity lanes read in place in wider packed buffers;
* K1c ``wildcard_match`` — ``_View.wildcard_const`` of the JAX
  evaluator (glob DP over the byte window, Kleene verdict).

(K3's plain version is held against the JAX ``MutateKernel`` in
``tests/test_torch_mutate.py``.)  On the CPU each wrapper takes its plain
version and counts no launch.  The kernels themselves, K3's among them,
run only on a CUDA card: those tests skip here and run on the card with
``python -m pytest tests/test_torch_kernels.py`` (``chip_smoke.py`` also
holds every kernel against its plain version at the main path's shapes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kyverno_tpu.compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT,
                                     TAG_INT, TAG_MAP, TAG_MISSING,
                                     TAG_NULL, TAG_STRING)
from kyverno_tpu.ops.eval import _View
from kyverno_tpu_torch.ops import kernels, vm
from test_torch_vm import host_vm  # noqa: F401

ALL_TAGS = (TAG_MISSING, TAG_NULL, TAG_BOOL, TAG_INT, TAG_FLOAT, TAG_STRING,
            TAG_MAP, TAG_ARRAY)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels have no '
                    'CPU mode (their plain versions are tested here)')
    return torch.device('cuda')


# ---------------------------------------------------------------------------
# K1h

def jax_fdet_select(rel: np.ndarray, fdet_u: np.ndarray, k: int):
    """The JAX evaluator's formulation (kyverno_tpu/ops/eval.py
    evaluate_packed, the fixed-budget fail-detail select)."""
    c = fdet_u.shape[1]
    col_idx = jnp.arange(c, dtype=jnp.int32)
    keys = jnp.where(jnp.asarray(rel), col_idx, jnp.int32(c))
    order = jnp.sort(keys, axis=1)[:, :k]
    fds = jnp.take_along_axis(
        jnp.asarray(fdet_u), jnp.minimum(order, c - 1).astype(jnp.int32),
        axis=1)
    return np.asarray(jnp.concatenate([order, fds.astype(jnp.int32)],
                                      axis=1))


def jax_tail(s_u, d_u, adm, fdet_u, match, rowvalid, uniq_any, k):
    """The JAX evaluator's tail after the status trees
    (kyverno_tpu/ops/eval.py evaluate_packed, :1789-1815): out8, out32."""
    rel = (jnp.asarray(s_u) == 1) & (jnp.asarray(match) != 0)   # FAIL
    if rowvalid is not None:
        rel = rel & (jnp.asarray(rowvalid) != 0)[:, None]
    parts = [rel] + [jnp.broadcast_to(rel[:, u:u + 1], (rel.shape[0], cnt))
                     for u, cnt in uniq_any]
    rel = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    out32 = jax_fdet_select(np.asarray(rel), fdet_u, k)
    out8 = jnp.concatenate([jnp.asarray(s_u), jnp.asarray(d_u),
                            jnp.asarray(adm)], axis=1)
    return np.asarray(out8), out32


def _k1h_inputs(rows, n_uniq, uniq_any, n_adm, density, seed,
                rowvalid=False, wide=False):
    """Seeded K1v outputs and lanes: ``density`` of the statuses FAIL;
    ``match`` (nine in ten set) and, with ``rowvalid``, a row-validity
    lane (one row in eight off) as the evaluator gets them — with
    ``wide``, columns of wider packed buffers beside other lanes.
    Returns the numpy arrays and the port's arguments."""
    rng = np.random.default_rng(seed)
    s_u = np.where(rng.random((rows, n_uniq)) < density, 1,
                   rng.choice(np.array([0, 2, 3, 4, 5]), (rows, n_uniq))
                   ).astype(np.int8)
    d_u = rng.integers(-2, 100, (rows, n_uniq)).astype(np.int8)
    adm = rng.integers(0, 2, (rows, n_adm)).astype(np.int8)
    cols = n_uniq + sum(cnt for _u, cnt in uniq_any)
    fdet = rng.integers(-3, 1 << 24, (rows, cols)).astype(np.int32)
    match = (rng.random((rows, n_uniq)) < 0.9).astype(np.uint8)
    mcol = 5 if wide else 0
    mbuf = rng.integers(0, 256, (rows, mcol + n_uniq + (7 if wide else 0))
                        ).astype(np.uint8)
    mbuf[:, mcol:mcol + n_uniq] = match
    rv = rv_lane = None
    if rowvalid:
        rv = (rng.random(rows) < 0.875).astype(np.int8)
        rcol = 3 if wide else 0
        rbuf = rng.integers(-5, 5, (rows, rcol + 1 + (4 if wide else 0))
                            ).astype(np.int8)
        rbuf[:, rcol] = rv
        rv_lane = (torch.from_numpy(rbuf), rcol)
    src = np.concatenate([np.arange(n_uniq)] + [
        np.full(cnt, u) for u, cnt in uniq_any]).astype(np.int32)
    args = (torch.from_numpy(s_u), torch.from_numpy(d_u),
            torch.from_numpy(adm), torch.from_numpy(fdet),
            (torch.from_numpy(mbuf), mcol), rv_lane, torch.from_numpy(src))
    return (s_u, d_u, adm, fdet, match, rv), args


K1H_CASES = [
    # rows, unique trees, uniq_any, admission columns, budget, density,
    # row-validity lane, lanes inside wider buffers
    (64, 26, (), 0, 26, 0.3, False, False),    # k == C (the smoke pack)
    (64, 40, (), 0, 32, 0.5, False, False),    # C > K: budget binds
    (64, 10, (), 0, 10, 0.0, False, False),    # no relevant column
    (64, 32, (), 0, 32, 1.0, False, False),    # k relevant in most rows
    (64, 90, (), 0, 32, 0.9, False, False),    # more than k relevant
    (5, 1, (), 0, 1, 0.5, False, False),       # one column
    (3, 7, (), 0, 0, 0.5, False, False),       # k == 0
    (0, 5, (), 0, 5, 0.5, False, False),       # no rows
    (64, 12, ((3, 4), (7, 2)), 3, 32, 0.5, True, True),  # uniq_any, k == C
    (64, 30, ((0, 5),), 2, 32, 0.9, True, True),  # rows over the budget
    (50, 8, ((2, 3),), 0, 4, 0.6, False, True),   # k < C, no rowvalid
    (40, 20, (), 5, 32, 0.7, True, False),        # rowvalid, packed alone
]


@pytest.mark.parametrize('rows,n_uniq,uniq_any,n_adm,budget,density,'
                         'rowvalid,wide', K1H_CASES)
def test_k1h_plain_matches_jax(rows, n_uniq, uniq_any, n_adm, budget,
                               density, rowvalid, wide):
    (s_u, d_u, adm, fdet, match, rv), args = _k1h_inputs(
        rows, n_uniq, uniq_any, n_adm, density, seed=rows * 31 + n_uniq,
        rowvalid=rowvalid, wide=wide)
    k = min(budget, fdet.shape[1])
    want8, want32 = jax_tail(s_u, d_u, adm, fdet, match, rv, uniq_any, k)
    out = kernels.fdet_select_plain(*args, k)
    assert out.dtype == torch.int8
    assert tuple(out.shape) == (rows, kernels.fdet_row_bytes(
        want8.shape[1], k)[0])
    got8, got32 = kernels.fdet_views(out, want8.shape[1], k)
    assert got8.dtype == torch.int8 and got32.dtype == torch.int32
    assert np.array_equal(got8.numpy(), want8)
    assert np.array_equal(got32.numpy(), want32)
    # the host copy splits the same way
    host8, host32 = kernels.fdet_views(out.numpy(), want8.shape[1], k)
    assert np.array_equal(host8, want8) and np.array_equal(host32, want32)


def test_k1h_zero_columns():
    _np, args = _k1h_inputs(4, 0, (), 0, 0.5, seed=0)
    out = kernels.fdet_select(*args, 0)
    assert tuple(out.shape) == (4, 0)
    got8, got32 = kernels.fdet_views(out, 0, 0)
    assert tuple(got8.shape) == (4, 0) and tuple(got32.shape) == (4, 0)
    assert jax_fdet_select(np.zeros((4, 0), bool), np.zeros((4, 0), np.int32),
                           0).shape == (4, 0)


def test_k1h_library_yardstick_matches():
    _np, args = _k1h_inputs(50, 30, ((4, 6),), 2, 0.4, seed=3,
                            rowvalid=True, wide=True)
    assert torch.equal(kernels.fdet_select_library(*args, 32),
                       kernels.fdet_select_plain(*args, 32))


def test_k1h_cpu_wrapper_takes_plain_and_counts_nothing():
    kernels.reset_launches()
    _np, args = _k1h_inputs(20, 12, ((1, 2),), 1, 0.5, seed=9,
                            rowvalid=True, wide=True)
    got = kernels.fdet_select(*args, 12)
    assert torch.equal(got, kernels.fdet_select_plain(*args, 12))
    assert kernels.LAUNCHES['k1h_fdet_select'] == 0


@pytest.mark.parametrize('fault', ['fdet_dtype', 'k_past_c', 'match_cols',
                                   'match_rows', 'match_stride', 'src_dtype',
                                   'src_len', 'd_u_shape', 'rowvalid_col',
                                   'adm_rows'])
def test_k1h_wrapper_checks(fault):
    _np, args = _k1h_inputs(4, 6, ((2, 1),), 1, 0.5, seed=1, rowvalid=True,
                            wide=True)
    s_u, d_u, adm, fdet, (mbuf, mcol), (rbuf, rcol), src = args
    k = 4
    if fault == 'fdet_dtype':
        fdet = fdet.long()
    elif fault == 'k_past_c':
        k = 8
    elif fault == 'match_cols':
        mcol = mbuf.shape[1] - 5
    elif fault == 'match_rows':
        mbuf = mbuf[:-1]
    elif fault == 'match_stride':
        mbuf = mbuf.t().contiguous().t()
    elif fault == 'src_dtype':
        src = src.long()
    elif fault == 'src_len':
        src = src[:-1]
    elif fault == 'd_u_shape':
        d_u = d_u[:, :-1]
    elif fault == 'rowvalid_col':
        rcol = rbuf.shape[1]
    elif fault == 'adm_rows':
        adm = adm[:-1]
    with pytest.raises(ValueError):
        kernels.fdet_select(s_u, d_u, adm, fdet, (mbuf, mcol), (rbuf, rcol),
                            src, k)


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n_uniq,uniq_any,n_adm,budget,density,'
                         'rowvalid,wide', K1H_CASES + [
                             (16384, 13, (), 0, 32, 0.3, True, True),
                             (999, 60, ((1, 9), (50, 4)), 3, 32, 0.6, True,
                              True),
                             (31, 1, (), 0, 1, 0.5, False, False)])
def test_k1h_cuda_kernel_matches_plain(rows, n_uniq, uniq_any, n_adm, budget,
                                       density, rowvalid, wide, cuda):
    _np, args = _k1h_inputs(rows, n_uniq, uniq_any, n_adm, density,
                            seed=n_uniq, rowvalid=rowvalid, wide=wide)
    k = min(budget, args[3].shape[1])
    card = [a if a is None else (a[0].to(cuda), a[1])
            if isinstance(a, tuple) else a.to(cuda) for a in args]
    before = kernels.LAUNCHES['k1h_fdet_select']
    got = kernels.fdet_select(*card, k)
    torch.cuda.synchronize()
    want = kernels.fdet_select_plain(*args, k)
    launched = rows > 0 and want.shape[1] > 0
    assert kernels.LAUNCHES['k1h_fdet_select'] == before + launched
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['compiler', 'conditions', 'foreach', 'pss',
                                  'smoke', 'wildcard_keys'])
def test_k1_call_on_the_card_equals_the_cpu_evaluator(name, cuda):
    """One K1 call on the card — K1v, then K1h reading the match and
    row-validity lanes inside their packed buffers (``conditions`` has
    ``uniq_any`` columns) — against the same evaluator on the CPU: out8
    and out32 byte-equal, one launch of each kernel, one copy back."""
    from test_torch_reference import load_pack, make_resources
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    _jp, tp = load_pack(name)
    tc = compile_policies(tp)
    host_ev, card_ev = build_evaluator(tc, 'cpu'), build_evaluator(tc, cuda)
    tensors = dict(encode_batch(make_resources(name, 300), tc,
                                padded_n=320).tensors())
    tensors['__match__'] = (np.random.default_rng(0).random(
        (320, host_ev.n_uniq)) < 0.8).astype(np.uint8)
    want8, want32 = host_ev(*shard_batch(tensors, 'cpu'))
    before = dict(kernels.LAUNCHES)
    got = card_ev(*shard_batch(tensors, cuda))
    got8, got32 = got.host()
    assert kernels.LAUNCHES['k1_vm'] == before['k1_vm'] + 1
    assert kernels.LAUNCHES['k1h_fdet_select'] == \
        before['k1h_fdet_select'] + 1
    assert np.array_equal(got8, want8.numpy())
    assert np.array_equal(got32, want32.numpy())
    assert np.array_equal(got[0].cpu().numpy(), got8)


# ---------------------------------------------------------------------------
# K1c

def jax_wildcard(head, str_len, tag, pattern: str):
    t = {'x_str_head': jnp.asarray(head), 'x_str_len': jnp.asarray(str_len),
         'x_tag': jnp.asarray(tag)}
    k = _View(t, 'x').wildcard_const(pattern)
    return np.asarray(k.t), np.asarray(k.f)


def _k1c_inputs(n, w, seed, alphabet=b'ab:-*?x\xc3\xa9latest'):
    """Values of every length class: empty, inside the window, exactly
    the window, past it (only the first w bytes are kept, as the
    encoder does), with non-ASCII bytes, under every tag."""
    rng = np.random.default_rng(seed)
    head = np.zeros((n, w), np.uint8)
    str_len = np.zeros(n, np.int32)
    for i in range(n):
        ln = int(rng.choice([0, 1, 3, max(w - 1, 0), w, w + 4,
                             int(rng.integers(0, w + 1))]))
        body = rng.choice(np.frombuffer(alphabet, np.uint8), size=min(ln, w))
        head[i, :len(body)] = body
        str_len[i] = ln
    tag = rng.choice(np.array(ALL_TAGS + (TAG_STRING,) * 4, np.int8), n)
    return head, str_len, tag


PATTERNS = ['*:*', '*', '?', '?*', '', 'a?b*', '*latest', '**a**', 'ab',
            'é?', '?é*', 'a' * 70, ':*:', '*-*-*']

#: long patterns: several stars, literal runs, '?' among them
LONG_PATTERNS = ['*a*b*:*x?*', 'ab*?:*latest*a', 'a?b?*:*?x*-*', '*' * 5,
                 ('*ab:?' * 12)[:60], 'a*' * 30, '?' * 64 + '*']


@pytest.mark.parametrize('w', [64, 16, 1])
@pytest.mark.parametrize('pattern', PATTERNS + LONG_PATTERNS)
def test_k1c_plain_matches_jax(pattern, w):
    head, str_len, tag = _k1c_inputs(300, w, seed=w + len(pattern))
    want_t, want_f = jax_wildcard(head, str_len, tag, pattern)
    got_t, got_f = kernels.wildcard_plain(
        torch.from_numpy(head), torch.from_numpy(str_len),
        torch.from_numpy(tag), pattern.encode())
    assert np.array_equal(got_t.numpy(), want_t)
    assert np.array_equal(got_f.numpy(), want_f)


def test_k1c_element_axes_match_jax():
    """[R, E, w] windows (per-container lanes), as the evaluator passes
    them."""
    head, str_len, tag = _k1c_inputs(4 * 5, 64, seed=11)
    head, str_len, tag = (head.reshape(4, 5, 64), str_len.reshape(4, 5),
                          tag.reshape(4, 5))
    want_t, want_f = jax_wildcard(head, str_len, tag, '*:*')
    got_t, got_f = kernels.wildcard_match(
        torch.from_numpy(head), torch.from_numpy(str_len),
        torch.from_numpy(tag), b'*:*')
    assert got_t.shape == (4, 5)
    assert np.array_equal(got_t.numpy(), want_t)
    assert np.array_equal(got_f.numpy(), want_f)


def test_k1c_verdict_cases():
    """Hand-picked cases: '?' over non-ASCII and over-window values are
    undecidable for strings (neither t nor f); arrays are never f;
    non-string scalars match through their string form."""
    cases = [  # (bytes, str_len, tag, pattern, t, f)
        (b'nginx:1', 7, TAG_STRING, '*:*', True, False),
        (b'nginx', 5, TAG_STRING, '*:*', False, True),
        (b'\xc3\xa9', 2, TAG_STRING, '?', False, False),
        (b'\xc3\xa9', 2, TAG_STRING, '*', True, False),
        (b'ab', 70, TAG_STRING, 'ab*', False, False),
        (b'', 0, TAG_ARRAY, '*', False, False),
        (b'', 0, TAG_MAP, '*', False, True),
        (b'12', 2, TAG_INT, '1?', True, False),
        (b'', 0, TAG_STRING, '', True, False),
        (b'', 0, TAG_STRING, '?*', False, True),
    ]
    w = 64
    head = np.zeros((len(cases), w), np.uint8)
    for i, c in enumerate(cases):
        head[i, :len(c[0])] = np.frombuffer(c[0], np.uint8)
    str_len = np.array([c[1] for c in cases], np.int32)
    tag = np.array([c[2] for c in cases], np.int8)
    for i, (_b, _l, _tg, pat, t_exp, f_exp) in enumerate(cases):
        t, f = kernels.wildcard_match(
            torch.from_numpy(head[i:i + 1]), torch.from_numpy(str_len[i:i + 1]),
            torch.from_numpy(tag[i:i + 1]), pat.encode())
        jt, jf = jax_wildcard(head[i:i + 1], str_len[i:i + 1],
                              tag[i:i + 1], pat)
        assert (bool(t[0]), bool(f[0])) == (t_exp, f_exp), cases[i]
        assert (bool(jt[0]), bool(jf[0])) == (t_exp, f_exp), cases[i]


def test_k1c_cpu_wrapper_takes_plain_and_counts_nothing():
    kernels.reset_launches()
    head, str_len, tag = _k1c_inputs(50, 64, seed=2)
    args = (torch.from_numpy(head), torch.from_numpy(str_len),
            torch.from_numpy(tag), b'*:*')
    got = kernels.wildcard_match(*args)
    want = kernels.wildcard_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES['k1c_wildcard'] == 0


def test_k1c_wrapper_checks():
    head, str_len, tag = _k1c_inputs(4, 8, seed=3)
    with pytest.raises(ValueError):
        kernels.wildcard_match(torch.from_numpy(head),
                               torch.from_numpy(str_len).long(),
                               torch.from_numpy(tag), b'*')
    with pytest.raises(ValueError):
        kernels.wildcard_match(torch.from_numpy(head)[:2],
                               torch.from_numpy(str_len),
                               torch.from_numpy(tag), b'*')


@pytest.mark.cuda
def test_k1c_cuda_kernel_matches_plain(cuda):
    """Every staging width (16-byte loads at w = 16 and 64, 4-byte at
    w = 8, bytes at w = 1 and 63 and from a window slab that starts one
    byte past an aligned address), a partial last block, every
    pattern."""
    for w, shift in ((64, 0), (16, 0), (8, 0), (63, 0), (1, 0), (64, 1),
                     (8, 1)):
        head, str_len, tag = _k1c_inputs(4096 + 77, w, seed=w + shift)
        args = [torch.from_numpy(a) for a in (head, str_len, tag)]
        flat = torch.zeros(head.size + shift, dtype=torch.uint8,
                           device=cuda)
        dev_head = flat[shift:].view(head.shape)
        dev_head.copy_(args[0].to(cuda))
        dev = [dev_head] + [a.to(cuda) for a in args[1:]]
        for pattern in PATTERNS + LONG_PATTERNS:
            pb = pattern.encode()
            want = kernels.wildcard_plain(*args, pb)
            got = kernels.wildcard_match(*dev, pb)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0]), (w, shift, pattern)
            assert torch.equal(got[1].cpu(), want[1]), (w, shift, pattern)


@pytest.mark.cuda
@pytest.mark.parametrize('counts,w,rows', [
    ([32, 1, 32, 5, 32, 0, 17, 32], 8, 1000),    # S > 32: blocks span rules
    ([32, 1, 32, 5, 32, 0, 17, 32], 256, 1000),  # 16-byte window loads
    ([32] * 8, 256, 333),                         # bit 31 in every rule
    ([2, 3, 1], 8, 16384),                        # the mutate pack's shape
    ([1] * 7000, 8, 50),       # past 48 KB of per-(row, rule) words
])
def test_k3_cuda_kernel_matches_plain(counts, w, rows, cuda):
    from types import SimpleNamespace
    from kyverno_tpu_torch.mutate.kernel import MutateKernel
    from test_torch_mutate import random_lanes, random_program
    prog = random_program(np.random.default_rng(w), len(counts), counts, w)
    host = MutateKernel(prog, 'cpu')
    card = MutateKernel(prog, cuda)
    lanes = random_lanes(np.random.default_rng(w + 1), host, rows)
    want = kernels.k3_mutate_plain(host.stage(lanes), host.site_tensors())
    before = kernels.LAUNCHES['k3_mutate']
    got = kernels.k3_mutate(card.stage(lanes), card.site_tensors(),
                            card.bounds)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['k3_mutate'] == before + 1
    assert torch.equal(got.cpu(), want)
    # and through the kernel object: one copy each way
    for g, wt in zip(card(lanes), host(lanes)):
        assert np.array_equal(g, wt)
    # a card rule_start without its host bounds is refused
    with pytest.raises(ValueError, match='host bounds'):
        kernels.k3_mutate(card.stage(lanes), card.site_tensors())
    # no sites: zeros, and no launch
    empty = MutateKernel(SimpleNamespace(programs=[
        SimpleNamespace(sites=[])]), cuda)
    lanes = random_lanes(np.random.default_rng(0), empty, 5)
    before = kernels.LAUNCHES['k3_mutate']
    got = kernels.k3_mutate(empty.stage(lanes), empty.site_tensors(),
                            empty.bounds)
    assert kernels.LAUNCHES['k3_mutate'] == before
    assert not got.any()


# ---------------------------------------------------------------------------
# K1v (its source is held against JAX on the CPU in tests/test_torch_vm.py)

def test_k1v_cpu_wrapper_takes_plain_and_counts_nothing():
    from test_torch_reference import make_resources
    from test_torch_eval import _evaluators
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import shard_batch
    _jc, _jev, tc, tev = _evaluators('smoke')
    packed, layout = shard_batch(encode_batch(make_resources('smoke', 9), tc,
                                              padded_n=16).tensors(), 'cpu')
    program = tev.plan_for(layout).program
    before = kernels.LAUNCHES['k1_vm']
    got = kernels.status_vm(packed, program)
    assert kernels.LAUNCHES['k1_vm'] == before
    for g, w in zip(got, program.plain(packed)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        kernels.status_vm({}, program)
    with pytest.raises(ValueError):
        kernels.status_vm({'pk_int8': packed['pk_int8'],
                           'pk_bool': packed['pk_bool'][:3]}, program)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['compiler', 'conditions', 'pss', 'smoke',
                                  'wildcard_keys'])
def test_k1v_cuda_kernel_matches_eager_walk(name, cuda):
    """K1v on the card against its plain version (the eager walk on the
    same card tensors), on encoded rows and on fuzzed lanes: bit-equal."""
    from test_torch_reference import load_pack, make_resources
    from test_torch_vm import _fuzz_packed
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, pack_batch
    _jp, tp = load_pack(name)
    tc = compile_policies(tp)
    ev = build_evaluator(tc, cuda)
    assert {r[0] for r in ev.routes.values()} == {'vm'}
    packed, layout = pack_batch(encode_batch(make_resources(name, 300), tc,
                                             padded_n=320).tensors())
    program = ev.plan_for(layout).program
    for seed, bufs in enumerate([packed] + [_fuzz_packed(packed, layout, s)
                                            for s in range(3)]):
        card = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                for k, v in bufs.items()}
        before = kernels.LAUNCHES['k1_vm']
        got = kernels.status_vm(card, program)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['k1_vm'] == before + 1
        want = program.plain(card)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), (name, seed)


def _k1v_card_case(name, rows, cuda):
    """(evaluator, program, packed numpy buffers, layout) of pack
    ``name`` over ``rows`` encoded rows, the evaluator on the card."""
    from test_torch_reference import load_pack, make_resources
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, pack_batch
    _jp, tp = load_pack(name)
    tc = compile_policies(tp)
    ev = build_evaluator(tc, cuda)
    packed, layout = pack_batch(encode_batch(make_resources(name, rows), tc,
                                             padded_n=rows).tensors())
    return ev, ev.plan_for(layout).program, packed, layout


def _k1v_equal(program, bufs, cuda, label):
    card = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
            for k, v in bufs.items()}
    before = kernels.LAUNCHES['k1_vm']
    got = kernels.status_vm(card, program)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['k1_vm'] == before + 1
    want = program.plain(card)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu()), label


@pytest.mark.cuda
@pytest.mark.parametrize('rows', [64, 16384])
@pytest.mark.parametrize('name', ['compiler', 'conditions', 'pss', 'smoke',
                                  'wildcard_keys'])
def test_k1v_parts_match_eager_walk_at_64_rows_and_a_chunk(name, rows, cuda):
    """K1v's parts, folded in the launch, and its loops that stop at
    each warp's largest count, against the eager walk on the same card
    tensors at the admission capacity and at a scan chunk, on encoded
    rows and on fuzzed lanes: bit-equal; every group staged."""
    from test_torch_vm import _fuzz_packed
    _ev, program, packed, layout = _k1v_card_case(name, rows, cuda)
    assert program.groups[:, 4].all()
    for seed, bufs in enumerate([packed] + [_fuzz_packed(packed, layout, s)
                                            for s in range(2)]):
        _k1v_equal(program, bufs, cuda, (name, rows, seed))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['pss', 'smoke'])
def test_k1v_global_mode_matches_eager_walk(name, cuda):
    """With a staging budget of 0 every block reads the device tables
    (the kernel's global mode): bit-equal to the eager walk, and the
    wrapper counts the groups it launched in that mode."""
    from test_torch_vm import _fuzz_packed
    _ev, program, packed, layout = _k1v_card_case(name, 320, cuda)
    flat = program.restaged(0)
    assert not flat.groups[:, 4].any()
    assert flat.smem_bytes == vm.GROUP_WARPS * vm.TILE_ROWS * vm.SLOT_BYTES
    kernels.reset_launches()
    for seed, bufs in enumerate([packed, _fuzz_packed(packed, layout, 1)]):
        _k1v_equal(flat, bufs, cuda, (name, seed))
    assert kernels.K1V_GROUPS == {'staged': 0, 'global': 2 * flat.n_groups}


@pytest.mark.cuda
def test_k1v_more_than_65535_entries_on_the_card(cuda, host_vm):
    """A program of 66,000 entries runs in one launch on the card, equal
    to the host build of the interpreter."""
    from test_torch_vm import run_host
    from test_torch_vm_parts import _many_entries
    prog, _one, packed = _many_entries(22_000)
    assert prog.n_entries > 65535
    card = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
            for k, v in packed.items()}
    got = kernels.status_vm(card, prog)
    torch.cuda.synchronize()
    want = run_host(host_vm, prog, packed)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), 'more than 65,535 entries'


def test_k1v_executed_count_is_the_card_kernels():
    """``status_vm_executed`` counts the card kernel's instructions: a
    CPU batch has no kernel to count."""
    from test_torch_reference import make_resources
    from test_torch_eval import _evaluators
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import shard_batch
    _jc, _jev, tc, tev = _evaluators('smoke')
    packed, layout = shard_batch(encode_batch(make_resources('smoke', 4), tc,
                                              padded_n=4).tensors(), 'cpu')
    with pytest.raises(ValueError):
        kernels.status_vm_executed(packed, tev.plan_for(layout).program)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['pss', 'smoke'])
def test_k1v_executed_instructions_on_the_card(name, cuda):
    """With every count past its width each warp runs every loop to its
    width: the card interprets exactly ``rows * row_insns``
    instructions; with the encoded counts, fewer."""
    _ev, program, packed, layout = _k1v_card_case(name, 320, cuda)
    counts = {}
    for label, bufs in (('encoded', packed), ('past', {
            k: np.array(v, copy=True) for k, v in packed.items()})):
        if label == 'past':
            for lane, (g, off, width, _t) in layout.items():
                if lane.endswith('_count'):
                    bufs[g][:, off:off + width] = 1 << 20
        card = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                for k, v in bufs.items()}
        counts[label] = kernels.status_vm_executed(card, program)
    assert counts['past'] == 320 * program.row_insns
    assert counts['encoded'] < counts['past']


@pytest.mark.cuda
def test_eager_float64_division_is_ieee_on_the_card(cuda):
    """The eager walk's float64 quotients (``float(key)`` of a milli or
    nanos lane) on the card equal the host's IEEE division: CUDA takes
    a Python-scalar divisor as a product with its reciprocal, so the
    walk divides by a device scalar (``ops/eval.py`` ``_fdiv``)."""
    from kyverno_tpu_torch.ops.eval import _fdiv
    x = torch.cat([torch.arange(-200000, 200001, dtype=torch.int64),
                   torch.randint(-(1 << 53), 1 << 53, (1 << 16,),
                                 generator=torch.Generator().manual_seed(0))])
    for div in (1000.0, 1e9):
        want = x.to(torch.float64) / div
        got = _fdiv(x.to(cuda), div).cpu()
        assert torch.equal(got, want), div


# ---------------------------------------------------------------------------
# the profiler's kernel events against the wrappers' launch counts

def _events(k1v_seen):
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    return [SimpleNamespace(device_type=DeviceType.CUDA, count=k1v_seen,
                            key='(anonymous namespace)::k1_vm_kernel'),
            SimpleNamespace(device_type=DeviceType.CPU, count=9,
                            key='k1_vm_kernel'),
            SimpleNamespace(device_type=DeviceType.CUDA, count=2,
                            key='fdet_select_kernel(int const*)')]


def test_kernel_event_counts_set_launches_beside_events():
    from kyverno_tpu_torch.observability.profiling import kernel_event_counts
    got = kernel_event_counts(_events(3), {'k1_vm': 4},
                              {'k1_vm': 9, 'k1h_fdet_select': 2})
    assert got == {'k1_vm': {'launches': 5, 'profiler_events': 3},
                   'k1h_fdet_select': {'launches': 2, 'profiler_events': 2}}


@pytest.mark.parametrize('seen', [3, 5])
def test_deep_profile_says_when_device_time_may_be_under_counted(
        seen, tmp_path, monkeypatch):
    """``deep_profile`` compares the kernel events of its trace with the
    launches the wrappers counted meanwhile, and says in its output that
    device time may be under-counted when the trace missed some."""
    from kyverno_tpu_torch.observability import profiling
    import torch.profiler as tp

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            pass

        def stop(self):
            pass

        def key_averages(self):
            return _events(seen)

        def export_chrome_trace(self, path):
            open(path, 'w').write('{}')

    def launches_while_sampling(seconds):
        kernels.LAUNCHES['k1_vm'] += 5
        kernels.LAUNCHES['k1h_fdet_select'] += 2
        return ''

    monkeypatch.setattr(profiling, '_cuda_live', lambda: True)
    monkeypatch.setattr(tp, 'profile', FakeProfile)
    monkeypatch.setattr(profiling, 'sample_profile', launches_while_sampling)
    monkeypatch.setattr(kernels, 'LAUNCHES', dict(kernels.LAUNCHES))
    out = profiling.deep_profile(0.01, out_dir=str(tmp_path))
    assert out['torch_trace']
    if seen < 5:
        assert out['kernel_events'] == {
            'k1_vm': {'launches': 5, 'profiler_events': seen}}
        assert 'under-counted' in out['note']
    else:
        assert 'note' not in out and 'kernel_events' not in out
