"""The evaluator's hand-written kernels' plain versions against the JAX
code they replace, on numpy-seeded inputs and the edge cases each must
keep:

* K1h ``fdet_select`` — the compact fail-detail select of the JAX
  ``evaluate_packed`` (``keys = where(rel, col, C)``, per-row sort, first
  k, clamped gather);
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


def _k1h_inputs(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    rel = rng.random((rows, cols)) < density
    fdet = rng.integers(-3, 1 << 24, (rows, cols)).astype(np.int32)
    return rel, fdet


@pytest.mark.parametrize('rows,cols,k,density', [
    (64, 26, 26, 0.3),      # k == C (the smoke pack's width)
    (64, 40, 32, 0.5),      # C > K: budget binds
    (64, 10, 10, 0.0),      # no relevant column
    (64, 32, 32, 1.0),      # exactly k relevant in every row
    (64, 90, 32, 0.9),      # more than k relevant
    (5, 1, 1, 0.5),         # one column
    (3, 7, 0, 0.5),         # k == 0
    (0, 5, 5, 0.5),         # no rows
])
def test_k1h_plain_matches_jax(rows, cols, k, density):
    rel, fdet = _k1h_inputs(rows, cols, density, seed=rows * 31 + cols)
    want = jax_fdet_select(rel, fdet, k)
    got = kernels.fdet_select_plain(torch.from_numpy(rel),
                                    torch.from_numpy(fdet), k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_k1h_zero_columns():
    rel = np.zeros((4, 0), bool)
    fdet = np.zeros((4, 0), np.int32)
    got = kernels.fdet_select(torch.from_numpy(rel), torch.from_numpy(fdet),
                              0)
    assert tuple(got.shape) == (4, 0)
    assert jax_fdet_select(rel, fdet, 0).shape == (4, 0)


def test_k1h_library_yardstick_matches():
    rel, fdet = _k1h_inputs(50, 40, 0.4, seed=3)
    a = kernels.fdet_select_library(torch.from_numpy(rel),
                                    torch.from_numpy(fdet), 32)
    assert np.array_equal(a.numpy(), jax_fdet_select(rel, fdet, 32))


def test_k1h_cpu_wrapper_takes_plain_and_counts_nothing():
    kernels.reset_launches()
    rel, fdet = _k1h_inputs(20, 12, 0.5, seed=9)
    got = kernels.fdet_select(torch.from_numpy(rel), torch.from_numpy(fdet),
                              12)
    want = kernels.fdet_select_plain(torch.from_numpy(rel),
                                     torch.from_numpy(fdet), 12)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES['k1h_fdet_select'] == 0


def test_k1h_wrapper_checks():
    rel, fdet = _k1h_inputs(4, 6, 0.5, seed=1)
    with pytest.raises(ValueError):
        kernels.fdet_select(torch.from_numpy(rel),
                            torch.from_numpy(fdet).long(), 4)
    with pytest.raises(ValueError):
        kernels.fdet_select(torch.from_numpy(rel), torch.from_numpy(fdet), 7)


@pytest.mark.cuda
def test_k1h_cuda_kernel_matches_plain(cuda):
    for rows, cols, k, density in [(16384, 26, 26, 0.3), (999, 70, 32, 0.6),
                                   (31, 1, 1, 0.5), (40, 33, 32, 1.0)]:
        rel, fdet = _k1h_inputs(rows, cols, density, seed=cols)
        rel_t, fd_t = torch.from_numpy(rel), torch.from_numpy(fdet)
        before = kernels.LAUNCHES['k1h_fdet_select']
        got = kernels.fdet_select(rel_t.to(cuda), fd_t.to(cuda), k)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['k1h_fdet_select'] == before + 1
        assert torch.equal(got.cpu(), kernels.fdet_select_plain(rel_t, fd_t,
                                                                k))


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


@pytest.mark.parametrize('w', [64, 16, 1])
@pytest.mark.parametrize('pattern', PATTERNS)
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
    for w in (64, 16, 1):
        head, str_len, tag = _k1c_inputs(4096, w, seed=w)
        args = [torch.from_numpy(a) for a in (head, str_len, tag)]
        for pattern in PATTERNS:
            pb = pattern.encode()
            want = kernels.wildcard_plain(*args, pb)
            got = kernels.wildcard_match(*[a.to(cuda) for a in args], pb)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0]), (w, pattern)
            assert torch.equal(got[1].cpu(), want[1]), (w, pattern)


@pytest.mark.cuda
def test_k3_cuda_kernel_matches_plain(cuda):
    from types import SimpleNamespace
    from kyverno_tpu_torch.mutate.kernel import MutateKernel
    from test_torch_mutate import random_lanes, random_program
    counts = [32, 1, 32, 5, 32, 0, 17, 32]
    for w in (8, 256):
        prog = random_program(np.random.default_rng(w), 8, counts, w)
        host = MutateKernel(prog, 'cpu')
        card = MutateKernel(prog, cuda)
        lanes = random_lanes(np.random.default_rng(w + 1), host, 1000)
        want = kernels.k3_mutate_plain(host.stage(lanes),
                                       host.site_tensors())
        before = kernels.LAUNCHES['k3_mutate']
        got = kernels.k3_mutate(card.stage(lanes), card.site_tensors())
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['k3_mutate'] == before + 1
        for g, wt in zip(got, want):
            assert torch.equal(g.cpu(), wt), w
    # no sites: zeros, and no launch
    empty = MutateKernel(SimpleNamespace(programs=[
        SimpleNamespace(sites=[])]), cuda)
    lanes = random_lanes(np.random.default_rng(0), empty, 5)
    before = kernels.LAUNCHES['k3_mutate']
    got = kernels.k3_mutate(empty.stage(lanes), empty.site_tensors())
    assert kernels.LAUNCHES['k3_mutate'] == before
    assert all(not o.any() for o in got)


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
