"""K1v's launch plan on the CPU: long trees cut into parts that the
kernel folds in one launch, loops that stop at the row's count, and a
program of more than 65,535 entries.  The host build of the interpreter
(``test_torch_vm.host_vm``: ``csrc/k1_vm_host.cpp``, which runs each
group's parts and then the same fold as the kernel's epilogue) is held
byte-equal to the unsplit program, to the JAX evaluator under the x64
shim and to the eager walk (K1v's plain version).  Every output is an
integer, so the tolerance is 0.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_eval import CAP, _evaluators, _run_jax, _run_torch
from test_torch_reference import PACKS, jax_reference, make_resources  # noqa: F401
from test_torch_vm import (_fuzz_packed, _ops_docs, _ops_evaluators,
                           _with_host_vm, host_vm, run_host)  # noqa: F401
from test_torch_vm_foreach import _docs, _foreach_entries
from test_torch_vm_foreach import _evaluators as _fe_evaluators
from kyverno_tpu_torch.ops import vm

#: PART_INSNS of the three plans: one part per tree, the default, and
#: every child of a seq root its own part (up to GROUP_WARPS)
SPLITS = {'unsplit': 1 << 60, 'default': vm.PART_INSNS, 'finest': 1}


def _fresh(tc, monkeypatch, part_insns):
    """A new evaluator of ``tc`` whose programs are lowered with
    ``PART_INSNS`` = ``part_insns``."""
    from kyverno_tpu_torch.ops.eval import build_evaluator
    monkeypatch.setattr(vm, 'PART_INSNS', part_insns)
    return build_evaluator(tc, 'cpu')


# ---------------------------------------------------------------------------
# the split program against the unsplit one, JAX and the eager walk

def _batch(name, jax_side):
    """(cps, evaluator, tensors) of a pack of PACKS (zero admission lanes), or
    of the admission-lanes pack or the restricted configuration (the
    admission lanes of real admission tuples), 40 rows at CAP."""
    import test_torch_eval
    import test_torch_vm_foreach
    if jax_side:
        from kyverno_tpu.compiler import admission
        from kyverno_tpu.compiler.encode import encode_batch
    else:
        from kyverno_tpu_torch.compiler import admission
        from kyverno_tpu_torch.compiler.encode import encode_batch
    if name in ('admission_lanes', 'restricted'):
        jc, jev, tc, tev = _fe_evaluators(name)
        docs = _docs(name, 40)
    else:
        jc, jev, tc, tev = _evaluators(name)
        docs = make_resources(name, 40)
    cps, ev = (jc, jev) if jax_side else (tc, tev)
    rng = np.random.default_rng(7)
    match = (rng.random((CAP, tev.n_uniq)) < 0.85).astype(np.uint8)
    if name in ('admission_lanes', 'restricted'):
        t = test_torch_vm_foreach._tensors(encode_batch, admission, cps, ev,
                                           docs, CAP, match, 7)
    else:
        t = test_torch_eval._tensors(encode_batch, admission.zero_lanes,
                                     cps, ev, docs, CAP, match)
    return cps, ev, t


@pytest.mark.parametrize('name', sorted(PACKS) + ['admission_lanes',
                                                  'restricted'])
def test_split_program_byte_equal_to_unsplit_jax_and_eager(
        name, jax_reference, host_vm, monkeypatch):
    from kyverno_tpu_torch.ops.eval import shard_batch
    _jc, jev, jt = _batch(name, True)
    tc, tev, tt = _batch(name, False)
    j8, j32 = _run_jax(jev, jt)
    e8, e32 = _run_torch(tev, tt)
    assert e8.tobytes() == j8.tobytes() and e32.tobytes() == j32.tobytes()
    _packed, layout = shard_batch(tt, 'cpu')
    parts = {}
    for label, part_insns in SPLITS.items():
        with monkeypatch.context() as m:
            ev = _fresh(tc, m, part_insns)
            _with_host_vm(m, host_vm)
            v8, v32 = _run_torch(ev, tt)
            parts[label] = ev.plan_for(layout).program.tree_parts
        assert v8.tobytes() == j8.tobytes(), label
        assert v32.tobytes() == j32.tobytes(), label
    assert set(parts['unsplit'].values()) == {1}
    if name in ('pss', 'smoke', 'restricted'):
        assert max(parts['default'].values()) > 1
    assert sum(parts['finest'].values()) >= sum(parts['default'].values())


@pytest.mark.parametrize('name', ['smoke', 'restricted'])
def test_long_trees_split_and_groups_are_contiguous(name):
    """The PSS trees are cut into parts of at most GROUP_WARPS; a tree's
    parts sit in consecutive warps of one group, the first of which
    folds them; each group's instructions and lanes are contiguous and
    its instructions index only its own lanes."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, tev = _fe_evaluators(name) if name == 'restricted' \
        else _evaluators(name)
    docs = _docs(name, 64) if name == 'restricted' \
        else make_resources(name, 64)
    _p, layout = pack_batch(encode_batch(docs, tc, padded_n=64).tensors())
    prog = tev.plan_for(layout).program
    assert max(prog.tree_parts.values()) == vm.GROUP_WARPS
    assert prog.warps.shape == (prog.n_groups * vm.GROUP_WARPS, 3)
    code_end = 0
    lane_end = 0
    for g, (c0, c1, l0, l1, staged) in enumerate(prog.groups.tolist()):
        assert (c0, l0) == (code_end, lane_end) and c1 > c0
        code_end, lane_end = c1, l1
        assert staged == 1
        ws = prog.warps[g * vm.GROUP_WARPS:(g + 1) * vm.GROUP_WARPS]
        w = 0
        while w < vm.GROUP_WARPS and ws[w, 0] >= 0:
            n = ws[w, 1]
            if n:                   # a tree's first part, then the rest
                assert prog.tree_parts[ws[w, 2]] == n
                assert (ws[w + 1:w + n, 1] == 0).all()
                assert (ws[w:w + n, 0] >= 0).all()
                w += n
            else:                   # an admission entry
                w += 1
        assert (ws[w:, 0] == -1).all()
        for ins in prog.code[c0:c1].tolist():
            for word in vm.LANE_WORDS_OF.get(vm.OPS[ins[0]], ()):
                assert ins[word] == -1 or l0 <= ins[word] < l1
    assert code_end == prog.code.shape[0]
    assert lane_end == prog.lanes.shape[0]
    assert prog.smem_bytes <= vm.GROUP_WARPS * vm.TILE_ROWS * \
        vm.SLOT_BYTES + vm.STAGE_BYTES


# ---------------------------------------------------------------------------
# the fold

def test_fold_equals_serial_sseq_over_random_triples(host_vm):
    """``k1vm_fold`` (the kernel's epilogue and the host build's) against
    K1_SSEQ's left fold, ``if (acc.s == PASS) acc = next``, over random
    triples: the first non-PASS triple, else the last."""
    rng = np.random.default_rng(0)
    out_s, out_d = ctypes.c_int8(), ctypes.c_int8()
    out_fd = ctypes.c_int32()
    for _ in range(2000):
        n = int(rng.integers(1, vm.GROUP_WARPS + 1))
        s = rng.choice(np.array([0, 0, 0, 1, 2, 3, 4, 5], np.int8), n)
        d = rng.integers(-3, 20, n).astype(np.int8)
        fd = rng.integers(-2, 1 << 24, n).astype(np.int32)
        acc = (s[0], d[0], fd[0])
        for i in range(1, n):
            if acc[0] == 0:
                acc = (s[i], d[i], fd[i])
        host_vm.fold(s.ctypes.data, d.ctypes.data, fd.ctypes.data, n,
                     ctypes.byref(out_s), ctypes.byref(out_d),
                     ctypes.byref(out_fd))
        assert (out_s.value, out_d.value, out_fd.value) == \
            tuple(int(v) for v in acc)


# ---------------------------------------------------------------------------
# loops that stop at the count

def _count_width(layout, name, e):
    prefix = name[:-len('_count')]
    tag = layout.get(f'{prefix}_tag')
    if prefix[0] in 'ge' and tag is not None and tag[3]:
        return tag[3][-1]
    return e


def _set_counts(packed, layout, rng, pool=None):
    """Every count lane redrawn per element from 0, 1, the width it
    counts, past that width and -1 (or from ``pool``), and a third of
    the overflow flags set: overflow rows with counts at and past the
    width."""
    e = vm.Layout(layout).E
    out = {k: np.array(v, copy=True) for k, v in packed.items()}
    for name, (g, off, width, _tail) in sorted(layout.items()):
        if name.startswith('__'):
            continue
        col = out[g][:, off:off + width]
        if name.endswith('_count'):
            w = _count_width(layout, name, e)
            choices = np.array(pool if pool is not None
                               else [0, 1, w, w + 1, w + 9, -1])
            col[:] = rng.choice(choices, col.shape)
        elif name.endswith('_overflow') and pool is None:
            col[:] = rng.random(col.shape) < 1 / 3
    return out


def _program(name, rows, seed):
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    if name == 'operators':
        _jc, _jev, tc, tev = _ops_evaluators()
        docs = _ops_docs(rows, seed=200 + seed)
    elif name == 'restricted':
        _jc, _jev, tc, tev = _fe_evaluators(name)
        docs = _docs(name, rows)
    else:
        _jc, _jev, tc, tev = _evaluators(name)
        docs = make_resources(name, rows, seed=200 + seed)
    packed, layout = pack_batch(encode_batch(docs, tc, padded_n=rows)
                                .tensors())
    return tev.plan_for(layout).program, packed, layout, tc


STOP_PACKS = sorted(n for n in PACKS) + ['operators', 'restricted']


@pytest.mark.parametrize('seed', range(2))
@pytest.mark.parametrize('name', STOP_PACKS)
def test_stop_at_count_equals_eager_on_fuzzed_counts(name, seed, host_vm):
    """Fuzzed lanes whose counts are 0, 1, the width, past it and -1,
    with overflow rows: the host build, whose marked loops stop at each
    row's count, equals the eager walk, which reads every element."""
    program, packed, layout, tc = _program(name, 96, seed)
    rng = np.random.default_rng(seed)
    fuzzed = _set_counts(_fuzz_packed(packed, layout, seed), layout, rng)
    # a foreach list's count stays within its width: the eager walk's
    # last-element gather indexes it (the encoder clamps every count)
    for entry in _foreach_entries(tc):
        g = f'g{tc.gathers.index(entry.list_gather)}'
        buf, off, _w, _t = layout[f'{g}_count']
        fuzzed[buf][:, off] = np.minimum(fuzzed[buf][:, off],
                                         layout[f'{g}_tag'][3][-1])
    tensors = {k: torch.from_numpy(v) for k, v in fuzzed.items()}
    want = program.plain(tensors)
    got = run_host(host_vm, program, fuzzed)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize('name', ['smoke', 'restricted', 'foreach'])
def test_stopped_loops_run_fewer_instructions(name, host_vm):
    """With every count past its width, every loop runs its full width
    and the host build executes exactly ``rows * row_insns``
    instructions; with every count 0, the marked loops stop at once,
    except a status loop's element 0, and it executes fewer."""
    program, packed, layout, _tc = _program(name, 32, 0)
    rng = np.random.default_rng(0)
    counts = {}
    for label, pool in (('past', [1 << 20]), ('zero', [0])):
        bufs = _set_counts(packed, layout, rng, pool=pool)
        executed = []
        run_host(host_vm, program, bufs, executed)
        counts[label] = executed[0]
    assert counts['past'] == 32 * program.row_insns
    assert counts['zero'] < counts['past']
    marks = [ins for ins in program.code.tolist()
             if vm.OPS[ins[0]] in ('LOOP', 'SLOOP')]
    assert any(ins[5] >= 0 for ins in marks)


def _lowering(name='smoke'):
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, _tev = _evaluators(name)
    _p, layout = pack_batch(encode_batch(make_resources(name, 4), tc,
                                         padded_n=4).tensors())
    info = vm.TreeInfo(tc, [], [], 0, 0)
    return vm.Lowering(info, vm.Layout(layout)), tc


def test_count_lane_proves_only_identity_bodies():
    """The stop rule's forms: ``~valid | x`` under AND, ``valid & x``
    under OR, MASK and PAIR of ``valid & ...`` under a bitwise OR are
    marked; a body without its own level's IDXLT, one whose IDXLT is
    another level's, one that is not the identity past the count, and a
    count lane that varies with the loop's own index are not."""
    lw, tc = _lowering()
    prefix = next(p for p in lw.info.array_prefix.values()
                  if lw.L.has(f'{p}_count') and
                  lw.L.entry(f'{p}_count')[3] == ())
    meta = vm.View(lw, prefix, ())
    count = meta.ref('count')
    x = meta.b('overflow')
    valid = vm.X('IDXLT', count, 0)
    assert lw.loop(0, 4, vm.RED_AND, ~valid | x).args[4] == count
    assert lw.loop(0, 4, vm.RED_OR, x & valid).args[4] == count
    assert lw.loop(0, 4, vm.RED_BOR, vm.mask(x, valid)).args[4] == count
    assert lw.loop(0, 4, vm.RED_BOR, vm.let(x, lambda v: vm.pair(
        valid & v, valid & vm.fof(v)))).args[4] == count
    assert lw.loop(0, 4, vm.RED_AND, x).args[4] == -1
    assert lw.loop(0, 4, vm.RED_AND, ~vm.X('IDXLT', count, 1) | x
                   ).args[4] == -1
    assert lw.loop(0, 4, vm.RED_AND, valid | x).args[4] == -1
    assert lw.loop(0, 4, vm.RED_OR, ~valid | x).args[4] == -1
    assert lw.loop(0, 4, vm.RED_BOR, vm.pair(valid & x, ~valid)
                   ).args[4] == -1
    # a nested loop's IDXLT of the outer level does not stop the outer
    inner = lw.loop(1, 4, vm.RED_AND, ~vm.X('IDXLT', count, 1) | valid)
    assert lw.loop(0, 4, vm.RED_OR, inner).args[4] == -1
    # a count that varies with the loop's index
    moving = lw.lane('pk_int32', 0, 1, [1, 0, 0, 0])
    assert lw.loop(0, 4, vm.RED_AND, ~vm.X('IDXLT', moving, 0) | x
                   ).args[4] == -1
    # status loops: marked on the valid test alone
    assert lw.count_lane(valid, 0, 0, mask=1) == count
    assert lw.count_lane(~valid, 0, 0, mask=1) == -1


# ---------------------------------------------------------------------------
# more than 65,535 entries

SMALL = (0, 1, 2)           # the smoke pack's shortest unique trees


def _many_entries(n_copies):
    """The smoke pack's trees SMALL repeated ``n_copies`` times, each
    copy its own unique columns, lowered at a 4-row layout: (program,
    one-copy program, packed buffers)."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, _tev = _evaluators('smoke')
    uniq = []
    for p in tc.programs:
        if p.status not in uniq:
            uniq.append(p.status)
    trees = [uniq[u] for u in SMALL]
    packed, layout = pack_batch(encode_batch(
        make_resources('smoke', 4, seed=3), tc, padded_n=4).tensors())
    out = []
    for copies in (n_copies, 1):
        many = trees * copies
        info = vm.TreeInfo(tc, many, [0] * len(many), len(many), len(many))
        out.append(vm.lower(info, range(len(many)), layout))
    # no anyPattern: the trees write no aux column
    assert 'SANY' not in [vm.OPS[c] for c in out[1].code[:, 0]]
    return out[0], out[1], packed


def test_more_than_65535_entries_lower_and_run(host_vm):
    """A program of 66,000 entries lowers and plans one launch (a linear
    grid of blocks, far under 2^31 - 1); its host build gives each copy
    the columns of the one-copy program."""
    copies = 22_000
    prog, one, packed = _many_entries(copies)
    assert prog.n_entries == 3 * copies > 65535
    assert prog.blocks(4) == prog.n_groups < (1 << 31) - 1
    assert prog.n_groups == -(-3 * copies // vm.GROUP_WARPS)
    got = run_host(host_vm, prog, packed)
    want = run_host(host_vm, one, packed)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w.repeat(1, copies))
