"""K1v's source on the CPU: the interpreter of ``csrc/k1_vm.cuh``,
compiled with the host compiler (``csrc/k1_vm_host.cpp``, a row loop
around the same functions the CUDA kernel runs), runs the bytecode of
``ops/vm.py`` on the packed numpy buffers.  Its outputs must be byte-
equal to the JAX evaluator's and to the port's eager walk (K1v's plain
version); every output is an integer, so the tolerance is 0.

The build needs ``g++``; without it these tests skip.  No entry point of
the port loads this build: the card runs ``csrc/k1_vm.cu`` (its tests
are the ``cuda`` ones in ``tests/test_torch_kernels.py``).
"""

import ctypes
import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_eval import (CAP, ROW_COUNTS, _evaluators, _run_jax,
                             _run_torch, _tensors)
from test_torch_reference import PACKS, jax_reference, load_pack, make_resources  # noqa: F401
from kyverno_tpu_torch.ops import kernels, vm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'kyverno_tpu_torch', 'csrc')
NON_FOREACH = sorted(n for n in PACKS if n != 'foreach')


@pytest.fixture(scope='module')
def host_vm(tmp_path_factory):
    """``k1_vm_host`` of ``csrc/k1_vm_host.cpp``, built with g++."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build csrc/k1_vm_host.cpp (the CPU '
                    'build of the K1v interpreter)')
    out = tmp_path_factory.mktemp('k1vm') / 'k1_vm_host.so'
    proc = subprocess.run(
        [gxx, '-std=c++17', '-O1', '-shared', '-fPIC', '-o', str(out),
         os.path.join(CSRC, 'k1_vm_host.cpp')],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    fn = lib.k1_vm_host
    fn.argtypes = [ctypes.POINTER(p), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_longlong] + [p] * 6 + [ctypes.c_int] * 2 + \
        [p] * 4 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    fold = lib.k1_vm_fold_host
    fold.argtypes = [p, p, p, ctypes.c_int, p, p, p]
    fold.restype = None
    fn.fold = fold
    return fn


def run_host(fn, program, packed, executed=None):
    """The host build of K1v over ``packed`` (numpy or CPU tensors):
    (s_u, d_u, fdet_u, adm) as CPU tensors, the columns of eager-routed
    trees zero (as the kernel's wrapper leaves them).  ``executed``, a
    one-element list, receives the instructions interpreted."""
    bufs = {k: np.ascontiguousarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in packed.items()}
    rows = next(iter(bufs.values())).shape[0]
    ptrs, widths = [], []
    for name, _dt in vm.BUFFERS:
        a = bufs.get(name)
        ptrs.append(None if a is None else a.ctypes.data)
        widths.append(0 if a is None else a.shape[1])
    s = np.zeros((rows, program.n_uniq), np.int8)
    d = np.zeros((rows, program.n_uniq), np.int8)
    fd = np.zeros((rows, program.n_cols_u), np.int32)
    adm = np.full((rows, program.n_adm), -1, np.int8)
    tabs = [np.ascontiguousarray(getattr(program, n))
            for n in ('code', 'lanes', 'i64', 'f64', 'bytes', 'warps')]
    count = ctypes.c_longlong(0)
    rc = fn((ctypes.c_void_p * 5)(*ptrs), (ctypes.c_longlong * 5)(*widths),
            rows, *[t.ctypes.data for t in tabs], program.n_groups,
            program.group_warps, s.ctypes.data, d.ctypes.data,
            fd.ctypes.data, adm.ctypes.data if program.n_adm else None,
            program.n_uniq, program.n_cols_u, program.n_adm,
            ctypes.byref(count))
    assert rc == 0
    if executed is not None:
        executed.append(count.value)
    return (torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(fd),
            torch.from_numpy(adm))


def _with_host_vm(monkeypatch, fn):
    """Route the evaluator's K1v calls to the host build."""
    monkeypatch.setattr(kernels, 'status_vm',
                        lambda packed, program: run_host(fn, program, packed))


# ---------------------------------------------------------------------------
# the whole evaluator, K1v's trees on the host build, against JAX

@pytest.mark.parametrize('n', ROW_COUNTS)
@pytest.mark.parametrize('name', sorted(PACKS))
def test_host_vm_byte_equal_to_jax_and_eager(name, n, jax_reference,
                                             host_vm, monkeypatch):
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu_torch.compiler import admission as tadm
    from kyverno_tpu_torch.compiler.encode import encode_batch as tencode
    jc, jev, tc, tev = _evaluators(name)
    docs = make_resources(name, max(ROW_COUNTS))[:n]
    rng = np.random.default_rng(n + 11)
    match = (rng.random((CAP, tev.n_uniq)) < 0.85).astype(np.uint8)
    jt = _tensors(jencode, jadm.zero_lanes, jc, jev, docs, CAP, match)
    tt = _tensors(tencode, tadm.zero_lanes, tc, tev, docs, CAP, match)
    j8, j32 = _run_jax(jev, jt)
    e8, e32 = _run_torch(tev, tt)
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        v8, v32 = _run_torch(tev, tt)
    assert v8.tobytes() == j8.tobytes() == e8.tobytes()
    assert v32.tobytes() == j32.tobytes() == e32.tobytes()


@pytest.mark.parametrize('name', sorted(PACKS) + ['admission_lanes'])
def test_routes_of_the_packs(name):
    """Every program of every pack, ``foreach`` trees included, is on
    K1v: a route comes only from a named kernel limit, and no tree of
    these packs is past one."""
    if name == 'admission_lanes':
        import yaml
        from kyverno_tpu_torch import smokepack
        from kyverno_tpu_torch.api.policy import Policy
        from kyverno_tpu_torch.compiler.compile import compile_policies
        from kyverno_tpu_torch.ops.eval import build_evaluator
        tc = compile_policies([Policy(d) for d in yaml.safe_load_all(
            smokepack.ADMISSION_LANES_PACK) if d])
        tev = build_evaluator(tc, 'cpu')
        assert tev.n_adm > 0
    else:
        _jc, _jev, tc, tev = _evaluators(name)
    assert tev.routes and set(tev.routes) == set(range(len(tc.programs)))
    assert set(tev.routes.values()) == {('vm', 'lowered')}, name


def test_mixed_routes_merge_equal_to_jax(jax_reference, host_vm,
                                         monkeypatch):
    """A policy set with ``foreach`` and plain rules, with K1v's locals
    limit cut below what the ``foreach`` trees need: those trees go to
    the eager walk under the named limit, and K1v's columns and the
    eager walk's merge in unique order, equal to JAX's output."""
    from kyverno_tpu.compiler.compile import compile_policies as jcomp
    from kyverno_tpu.ops.eval import build_evaluator as jbuild
    from kyverno_tpu_torch.compiler.compile import compile_policies as tcomp
    from kyverno_tpu_torch.ops.eval import build_evaluator as tbuild
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu_torch.compiler import admission as tadm
    from kyverno_tpu_torch.compiler.encode import encode_batch as tencode
    jp1, tp1 = load_pack('foreach')
    jp2, tp2 = load_pack('compiler')
    jc, tc = jcomp(jp2 + jp1), tcomp(tp2 + tp1)
    monkeypatch.setattr(vm, 'LOCALS', 3)
    jev, tev = jbuild(jc), tbuild(tc, 'cpu')
    kinds = {r[0] for r in tev.routes.values()}
    assert kinds == {'vm', 'eager'}
    for j, prog in enumerate(tc.programs):
        route, reason = tev.routes[j]
        if prog.policy_index >= len(tp2):
            assert route == 'eager' and reason.startswith('locals ')
        else:
            assert route == 'vm'
    docs = make_resources('foreach', 40) + make_resources('compiler', 40)
    random.Random(3).shuffle(docs)
    match = np.ones((CAP, tev.n_uniq), np.uint8)
    jt = _tensors(jencode, jadm.zero_lanes, jc, jev, docs, CAP, match)
    tt = _tensors(tencode, tadm.zero_lanes, tc, tev, docs, CAP, match)
    j8, j32 = _run_jax(jev, jt)
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        v8, v32 = _run_torch(tev, tt)
    assert v8.tobytes() == j8.tobytes()
    assert v32.tobytes() == j32.tobytes()


def test_raw_packed_entry_matches_eager(host_vm, monkeypatch):
    """``evaluator.raw(packed, layout)`` (the mesh step's entry) in
    program space, K1v on the host build against the eager walk."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import shard_batch
    _jc, _jev, tc, tev = _evaluators('smoke')
    docs = make_resources('smoke', 70)
    packed, layout = shard_batch(encode_batch(docs, tc, padded_n=128)
                                 .tensors(), 'cpu')
    want = tev.raw(packed, layout)
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        got = tev.raw(packed, layout)
    assert want[0].shape == (128, len(tc.programs))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the operators pack: anyPattern children that skip, duration, float,
# quantity and semver thresholds hit exactly, list equality and ranges

OPS_PACK = '''
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: vm-numeric
spec:
  validationFailureAction: Audit
  background: true
  rules:
    - name: duration-pairs
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "deadline"
        deny:
          conditions:
            any:
              - key: "{{request.object.spec.activeDeadlineSeconds}}"
                operator: GreaterThan
                value: "0.3s"
              - key: "{{request.object.spec.terminationGracePeriodSeconds}}"
                operator: LessThanOrEquals
                value: "0.7s"
              - key: "{{request.object.metadata.annotations.timeout}}"
                operator: GreaterThanOrEquals
                value: 2.3
    - name: floats-and-quantities
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "numbers"
        deny:
          conditions:
            any:
              - key: "{{request.object.spec.priority}}"
                operator: Equals
                value: "199.98"
              - key: "{{request.object.metadata.annotations.ratio}}"
                operator: LessThan
                value: 4.35
              - key: "{{request.object.metadata.annotations.mem}}"
                operator: GreaterThan
                value: "1Gi"
              - key: "{{request.object.metadata.annotations.cpu}}"
                operator: Equals
                value: "500m"
              - key: "{{request.object.metadata.annotations.version}}"
                operator: GreaterThanOrEquals
                value: "1.2.3"
    - name: lists-and-ranges
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "lists"
        deny:
          conditions:
            all:
              - key: "{{request.object.metadata.finalizers}}"
                operator: NotEquals
                value: ["a.io/x", "b.io/y"]
              - key: "{{request.object.spec.containers[].ports[].containerPort}}"
                operator: AllNotIn
                value: "100-200"
              - key: "{{request.object.metadata.annotations.tier}}"
                operator: AnyIn
                value: ["gold", "silver*", 3, 2.5, true]
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: vm-patterns
spec:
  validationFailureAction: Audit
  background: true
  rules:
    - name: any-of-three
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "none of the patterns"
        anyPattern:
          - spec:
              (hostNetwork): true
              containers:
                - name: "?*"
          - spec:
              (dnsPolicy): "ClusterFirst*"
              containers:
                - image: "*:*"
          - metadata:
              (labels):
                (app): "?*"
              annotations:
                owner: "team-*"
    - name: leaves
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "leaves"
        pattern:
          spec:
            =(activeDeadlineSeconds): ">=1h | <10"
            =(terminationGracePeriodSeconds): "1-30"
            =(priorityClassName): "!default"
            containers:
              - =(resources):
                  =(limits):
                    =(memory): "<=2Gi"
                    =(cpu): "?*"
'''


def make_ops_pod(rng, i):
    pick = rng.choice
    ann = {}
    for key, pool in (
            ('timeout', [2.3, '2.3', '2.3s', 2, 3, '1h', 'x', None]),
            ('ratio', ['4.35', '4.349', '4.35e0', '5', 'nan', 'abc']),
            ('mem', ['1Gi', '1025Mi', '1073741824', '0.5Gi', '2Gi', 'x']),
            ('cpu', ['500m', '0.5', '1', '500', 'm']),
            ('version', ['1.2.3', '1.2.2', '1.10.0', 'v1.2.3', '2']),
            ('tier', ['gold', 'silver-2', 'bronze', '3', '2.5', 'true']),
            ('owner', ['team-a', 'team', 'x-team-a', ''])):
        if rng.random() < 0.7:
            v = pick(pool)
            if v is not None:
                ann[key] = str(v)
    containers = []
    for c in range(rng.randint(1, 3)):
        cont = {'name': pick(['', 'app', 'side']),
                'image': pick(['nginx:1', 'nginx', 'a/b:c', ''])}
        if rng.random() < 0.6:
            cont['ports'] = [{'containerPort': pick([80, 100, 150, 200, 201,
                                                     '150', 99])}
                             for _ in range(rng.randint(1, 3))]
        if rng.random() < 0.6:
            lim = {}
            if rng.random() < 0.7:
                lim['memory'] = pick(['2Gi', '2049Mi', '1Gi', '3G', 'x', 5])
            if rng.random() < 0.5:
                lim['cpu'] = pick(['1', '', 0.5, '250m'])
            cont['resources'] = {'limits': lim}
        containers.append(cont)
    spec = {'containers': containers}
    for key, pool in (
            ('activeDeadlineSeconds', [0.3, 0.31, 0.29, '0.3', 3600, 5, 11,
                                       '1h', 7200]),
            ('terminationGracePeriodSeconds', [0.7, 0.69, 0.71, 1, 30, 31,
                                               '0.7']),
            ('priority', [199.98, '199.98', 199.97, 200, 0]),
            ('hostNetwork', [True, False, 'true']),
            ('dnsPolicy', ['ClusterFirst', 'ClusterFirstWithHostNet',
                           'Default']),
            ('priorityClassName', ['default', 'high', ''])):
        if rng.random() < 0.5:
            spec[key] = pick(pool)
    meta = {'name': f'o{i}', 'namespace': 'default'}
    if ann:
        meta['annotations'] = ann
    if rng.random() < 0.5:
        meta['labels'] = {'app': pick(['web', '', 'x'])}
    if rng.random() < 0.5:
        meta['finalizers'] = pick([['a.io/x', 'b.io/y'], ['a.io/x'],
                                   ['b.io/y', 'a.io/x'], []])
    return {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': meta,
            'spec': spec}


_OPS = {}


def _ops_evaluators():
    """(JAX cps, JAX evaluator, port cps, port evaluator) of OPS_PACK."""
    if not _OPS:
        import yaml
        from kyverno_tpu.api.policy import Policy as JaxPolicy
        from kyverno_tpu.compiler.compile import compile_policies as jcomp
        from kyverno_tpu.ops.eval import build_evaluator as jbuild
        from kyverno_tpu_torch.api.policy import Policy as TorchPolicy
        from kyverno_tpu_torch.compiler.compile import \
            compile_policies as tcomp
        from kyverno_tpu_torch.ops.eval import build_evaluator as tbuild
        docs = [d for d in yaml.safe_load_all(OPS_PACK) if d]
        jc = jcomp([JaxPolicy(d) for d in docs])
        tc = tcomp([TorchPolicy(d) for d in docs])
        _OPS['ev'] = (jc, jbuild(jc), tc, tbuild(tc, 'cpu'))
    return _OPS['ev']


def _ops_docs(n, seed=5):
    rng = random.Random(seed)
    return [make_ops_pod(rng, i) for i in range(n)]


@pytest.mark.parametrize('n', ROW_COUNTS)
def test_ops_pack_host_vm_byte_equal_to_jax_and_eager(n, jax_reference,
                                                      host_vm, monkeypatch):
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu_torch.compiler import admission as tadm
    from kyverno_tpu_torch.compiler.encode import encode_batch as tencode
    jc, jev, tc, tev = _ops_evaluators()
    assert tc.host_rules == [] and len(tc.programs) == 15
    assert {r[0] for r in tev.routes.values()} == {'vm'}
    docs = _ops_docs(max(ROW_COUNTS))[:n]
    match = np.ones((CAP, tev.n_uniq), np.uint8)
    jt = _tensors(jencode, jadm.zero_lanes, jc, jev, docs, CAP, match)
    tt = _tensors(tencode, tadm.zero_lanes, tc, tev, docs, CAP, match)
    j8, j32 = _run_jax(jev, jt)
    e8, e32 = _run_torch(tev, tt)
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        v8, v32 = _run_torch(tev, tt)
    assert v8.tobytes() == j8.tobytes() == e8.tobytes()
    assert v32.tobytes() == j32.tobytes() == e32.tobytes()


# ---------------------------------------------------------------------------
# fuzzed lanes: the host build against the eager walk

def _fuzz_packed(packed, layout, seed):
    """The packed buffers with each lane's rows shuffled independently
    (real values in combinations no encoder emits), and a third of the
    lanes redrawn at random from their domain."""
    rng = np.random.default_rng(seed)
    out = {k: np.array(v, copy=True) for k, v in packed.items()}
    rows = next(iter(out.values())).shape[0]
    for name, (g, off, width, tail) in sorted(layout.items()):
        if name.startswith('__'):
            continue
        col = out[g][:, off:off + width]
        col[:] = col[rng.permutation(rows)]
        if rng.random() >= 1 / 3:
            continue
        suffix = name.split('_', 1)[1]
        shape = col.shape
        if suffix == 'tag':
            col[:] = rng.integers(0, 8, shape)
        elif suffix == 'kind':
            col[:] = rng.integers(0, 3, shape)
        elif suffix == 'count':
            col[:] = rng.integers(0, (tail[-1] if tail else 8) + 2, shape)
        elif suffix == 'str_len':
            col[:] = rng.integers(0, 80, shape)
        elif suffix in ('milli', 'nanos'):
            pool = np.array([0, 1, -1, 999, 1000, 1500, 250, 10 ** 9,
                             1 << 53, (1 << 53) + 1, -(1 << 53) - 1,
                             -(1 << 63), (1 << 63) - 1, 123456789012],
                            np.int64)
            col[:] = np.where(rng.random(shape) < 0.5,
                              rng.choice(pool, shape),
                              rng.integers(-10 ** 7, 10 ** 7, shape) * 1000)
        elif col.dtype == np.uint8:
            alphabet = np.frombuffer(b'ab:-*?x.\xc3\xa9latest/019[ ', np.uint8)
            col[:] = rng.choice(alphabet, shape)
        elif col.dtype == bool:
            col[:] = rng.random(shape) < 0.5
    return out


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('name', NON_FOREACH + ['operators'])
def test_host_vm_equals_eager_on_fuzzed_lanes(name, seed, host_vm):
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    if name == 'operators':
        _jc, _jev, tc, tev = _ops_evaluators()
        docs = _ops_docs(96, seed=100 + seed)
    else:
        _jc, _jev, tc, tev = _evaluators(name)
        docs = make_resources(name, 96, seed=100 + seed)
    packed, layout = pack_batch(encode_batch(docs, tc, padded_n=96)
                                .tensors())
    fuzzed = _fuzz_packed(packed, layout, seed)
    program = tev.plan_for(layout).program
    tensors = {k: torch.from_numpy(v) for k, v in fuzzed.items()}
    want = program.plain(tensors)
    got = run_host(host_vm, program, fuzzed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the lowering

def _lane_column(packed, lane_row, r, idx, j=0):
    """Python mirror of ``k1vm_addr`` + load for one lane-table row
    (``j``: the byte within a byte lane's element)."""
    b, off, stride, c0, c1, c2, const, c3 = lane_row
    e = c0 * idx[0] + c1 * idx[1] + c2 * idx[2] + c3 * idx[3] + const
    return packed[vm.BUFFERS[b][0]][r, off + e * stride + j]


@pytest.mark.parametrize('name', sorted(PACKS))
def test_lane_offsets_equal_unpack_batch_slices(name):
    """Every lane a View resolves reads, at every index, the element
    ``unpack_batch`` gives for that lane; a per-foreach-element gather's
    lanes at levels (3, 2), its metadata at level 3."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch, unpack_batch
    _jc, _jev, tc, tev = _evaluators(name)
    docs = make_resources(name, 8)
    packed, layout = pack_batch(encode_batch(docs, tc, padded_n=8).tensors())
    lanes = unpack_batch(packed, layout)
    info = vm.TreeInfo(tc, [], [], 0, 0)
    lw = vm.Lowering(info, vm.Layout(layout))
    rng = np.random.default_rng(0)
    checked = 0
    for lname in sorted(layout):
        prefix, _, suffix = lname.partition('_')
        if lname.startswith('__'):
            continue
        arr = lanes[lname]
        byte = suffix in ('str_head', 'str_tail')
        dims = arr.shape[1:-1] if byte else arr.shape[1:]
        gathered = (prefix[0] == 'g' and len(dims) == 1) or \
            (prefix[0] == 'e' and len(dims) == 2)
        if gathered:
            view = lw.gather_view(prefix)
        elif prefix[0] == 'e':
            view = lw.row_view(prefix)
        else:
            view = vm.View(lw, prefix, tuple(range(len(dims))))
        levels = view.levels
        row = lw.lane_rows[view.ref(suffix)]
        for _ in range(4):
            r = int(rng.integers(0, 8))
            at = [int(rng.integers(0, n)) for n in dims]
            idx = [0, 0, 0, 0]
            for lvl, i in zip(levels, at):
                idx[lvl] = i
            want = arr[(r, *at)]
            if byte:
                got = [_lane_column(packed, row, r, idx, j)
                       for j in range(arr.shape[-1])]
                assert list(want) == got, lname
            else:
                assert want == _lane_column(packed, row, r, idx), lname
            checked += 1
        if gathered:
            k = int(rng.integers(0, dims[-1]))
            row = lw.lane_rows[view.at(k).ref(suffix)]
            r = int(rng.integers(0, 8))
            outer = [int(rng.integers(0, n)) for n in dims[:-1]]
            idx = [0, 0, 0, 0]
            for lvl, i in zip(levels, outer):
                idx[lvl] = i
            want = arr[(r, *outer, k)]
            got = [_lane_column(packed, row, r, idx, j)
                   for j in range(arr.shape[-1])] if byte \
                else _lane_column(packed, row, r, idx)
            assert (list(want) if byte else want) == got, lname
    assert checked > 0
    if name == 'foreach':
        assert any(n.startswith('e') for n in layout)


def test_pools_round_trip():
    gen = vm._Gen()
    ints = [0, -1, (1 << 63) - 1, -(1 << 63), 1 << 53, 7, 0]
    idx = [gen.i64_index(v) for v in ints]
    assert idx[0] == idx[-1]
    assert [int(np.asarray(gen.i64, np.int64)[i]) for i in idx] == ints
    floats = [0.0, -0.0, 1e-9, float('inf'), 1 / 3, 0.1 + 0.2]
    fidx = [gen.f64_index(v) for v in floats]
    assert len(set(fidx)) == len(floats)      # -0.0 is kept apart from 0.0
    arr = np.asarray(gen.f64, np.float64)
    assert [arr[i].tobytes() for i in fidx] == \
        [np.float64(v).tobytes() for v in floats]
    consts = [b'latest', b'', b'*:*', b'\xc3\xa9?', b'latest']
    offs = [gen.bytes_index(b) for b in consts]
    assert offs[0] == offs[-1]
    pool = bytes(gen.bytes)
    assert [pool[o:o + len(b)] for o, b in zip(offs, consts)] == consts


def test_program_pools_hold_the_packs_constants():
    """A lowered program's BYTES and GLOB instructions point at their
    constants in the byte pool, and CI's at their int64s."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, tev = _evaluators('smoke')
    _packed, layout = pack_batch(encode_batch(make_resources('smoke', 4), tc,
                                              padded_n=4).tensors())
    prog = tev.plan_for(layout).program
    pool = prog.bytes.tobytes()
    globs = {pool[ins[4]:ins[4] + ins[5]] for ins in prog.code.tolist()
             if ins[0] == vm.OP['GLOB']}
    assert b'*:*' in globs
    eqs = {pool[ins[3]:ins[3] + ins[4]].rstrip(b'\0')
           for ins in prog.code.tolist() if ins[0] == vm.OP['BYTES']}
    assert b'!*:latest' in eqs and b':latest' in eqs
    for ins in prog.code.tolist():
        if ins[0] == vm.OP['CI']:
            assert 0 <= ins[3] < len(prog.i64)


def test_abi_constants_match_the_header():
    """The opcodes, limits, status codes and tags of ``ops/vm.py`` and
    ``compiler/ir.py`` are the ones ``k1_vm.cuh`` compiles in."""
    from kyverno_tpu_torch.compiler import ir
    src = open(os.path.join(CSRC, 'k1_vm.cuh')).read()
    enum = re.search(r'enum K1vmOp \{(.*?)\};', src, re.S).group(1)
    names = [n.strip()[len('K1_'):] for n in enum.split(',') if n.strip()]
    assert names == list(vm.OPS)
    define = dict(re.findall(r'#define (K1VM_\w+) (\d+)\n', src))
    assert int(define['K1VM_KSTACK']) == vm.KSTACK
    assert int(define['K1VM_SSTACK']) == vm.SSTACK
    assert int(define['K1VM_LOCALS']) == vm.LOCALS
    assert int(define['K1VM_FRAMES']) == vm.FRAMES
    assert int(define['K1VM_INSN']) == vm.INSN_WORDS
    assert int(define['K1VM_LANE']) == vm.LANE_WORDS
    for code in ('PASS', 'FAIL', 'SKIP', 'HOST', 'VAR_ERR'):
        assert int(define[f'K1VM_{code}']) == getattr(ir, f'STATUS_{code}')
    assert int(define['K1VM_TAG_MISSING']) == ir.TAG_MISSING
    assert int(define['K1VM_TAG_ARRAY']) == ir.TAG_ARRAY
    conv = re.search(r'#define K1VM_CONV_TAGS (.*)\n', src).group(1)
    bits = {int(b) for b in re.findall(r'1u << (\d+)', conv)}
    assert bits == {ir.TAG_STRING, ir.TAG_INT, ir.TAG_FLOAT, ir.TAG_BOOL}


def test_tree_past_a_limit_routes_eager():
    """A tree deeper than the Kleene stack is routed to the eager walk
    with the limit named; a route never comes from a failed call."""
    from kyverno_tpu_torch.compiler.ir import BoolExpr, Leaf, StatusExpr
    _jc, _jev, tc, _tev = _evaluators('compiler')
    slot = tc.slots[0]
    expr = BoolExpr.of(Leaf(slot, 'present'))
    for _ in range(vm.KSTACK + 1):
        expr = BoolExpr('and', children=(BoolExpr.of(Leaf(slot, 'absent')),
                                         expr))
    deep = StatusExpr('leaf', expr=expr)
    from kyverno_tpu_torch.ops.eval import _probe_layout
    info = vm.TreeInfo(tc, [deep], [0], 1, 1)
    routes = vm.route_trees(info, _probe_layout(tc))
    assert routes[0][0] == 'eager' and 'Kleene stack' in routes[0][1]


def test_pattern_past_the_limit_routes_eager():
    """A glob pattern longer than MAX_PATTERN is a named limit: the tree
    goes to the eager walk with the limit in its reason."""
    from kyverno_tpu_torch.compiler.ir import BoolExpr, Leaf, StatusExpr
    from kyverno_tpu_torch.ops.eval import _probe_layout
    _jc, _jev, tc, _tev = _evaluators('wildcard_keys')
    probe = _probe_layout(tc)
    slot = next(s for i, s in enumerate(tc.slots)
                if f's{i}_str_head' in probe)
    routes = {}
    for n in (vm.MAX_PATTERN // 2, vm.MAX_PATTERN // 2 + 1):
        tree = StatusExpr('leaf', expr=BoolExpr.of(
            Leaf(slot, 'wildcard', 'a?' * n)))
        info = vm.TreeInfo(tc, [tree], [0], 1, 1)
        routes[2 * n] = vm.route_trees(info, probe)[0]
    assert routes[vm.MAX_PATTERN] == ('vm', 'lowered')
    over = routes[vm.MAX_PATTERN + 2]
    assert over[0] == 'eager' and 'glob pattern bytes' in over[1]


def test_tree_the_vm_cannot_lower_fails_the_build():
    """Short of the named limits every tree goes to K1v: a tree the
    lowering cannot take raises at build time and is never routed to
    the eager walk."""
    import copy
    import dataclasses
    from kyverno_tpu_torch.compiler.ir import BoolExpr, Leaf, StatusExpr
    from kyverno_tpu_torch.ops.eval import _probe_layout, build_evaluator
    _jc, _jev, tc, _tev = _evaluators('compiler')
    bad = StatusExpr('leaf', expr=BoolExpr.of(
        Leaf(tc.slots[0], 'no_such_op')))
    info = vm.TreeInfo(tc, [bad], [0], 1, 1)
    with pytest.raises(vm.LoweringError, match='unknown leaf op'):
        vm.route_trees(info, _probe_layout(tc))
    broken = copy.copy(tc)
    broken.programs = [dataclasses.replace(tc.programs[0], status=bad)] + \
        list(tc.programs[1:])
    with pytest.raises(vm.LoweringError, match='unknown leaf op'):
        build_evaluator(broken, 'cpu')
