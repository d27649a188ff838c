"""K1v on the rest of K1, on the CPU: ``foreach`` trees (per-foreach-
element gathers, mode-B conditions, the per-entry error rule) and the
per-row admission match (K1i).  The interpreter of ``csrc/k1_vm.cuh``,
built with the host compiler (``test_torch_vm.host_vm``), and the eager
walk with ``_adm_match_graph`` (K1v's plain version) are each held
byte-equal to the JAX evaluator under the x64 shim, with admission
lanes encoded from real admission tuples; fuzzed lanes hold the host
build against the plain version.  Every output is an integer, so the
tolerance is 0.  The card build's test carries the ``cuda`` marker.
"""

import random

import numpy as np
import pytest
import torch
import yaml

import test_foreach_compile
from test_torch_eval import CAP, ROW_COUNTS, _run_jax, _run_torch
from test_torch_reference import jax_reference, load_pack  # noqa: F401
from test_torch_vm import _fuzz_packed, _with_host_vm, host_vm, run_host  # noqa: F401
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.ops import kernels, vm

# ---------------------------------------------------------------------------
# the mode-B operators pack: every key kind of _b_equals (bool, int,
# float, duration, quantity, plain and wildcard strings) and the four
# ``in`` variants with scalar keys, over per-element gathers that may be
# missing (notfound), lists with null elements and lists past the
# encoder's gather width

MODE_B_PACK = '''
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: mode-b-equals
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: bool-and-numbers
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: equals on numbers
        foreach:
          - list: request.object.spec.containers
            deny:
              conditions:
                any:
                  - key: true
                    operator: Equals
                    value: "{{ element.securityContext.privileged || `false` }}"
                  - key: 80
                    operator: Equals
                    value: "{{ element.port || `0` }}"
                  - key: 0.5
                    operator: Equals
                    value: "{{ element.cpu || `0` }}"
    - name: durations
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: equals on durations
        foreach:
          - list: request.object.spec.containers
            deny:
              conditions:
                any:
                  - key: "30s"
                    operator: Equals
                    value: "{{ element.timeout }}"
                  - key: "300000000h"
                    operator: NotEquals
                    value: "{{ element.timeout || 'x' }}"
    - name: quantities-and-strings
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: equals on quantities and strings
        foreach:
          - list: request.object.spec.containers
            preconditions:
              all:
                - key: "{{ element.name }}"
                  operator: NotEquals
                  value: skipme
            deny:
              conditions:
                any:
                  - key: "1Gi"
                    operator: Equals
                    value: "{{ element.memory || '' }}"
                  - key: "0.0001m"
                    operator: Equals
                    value: "{{ element.memory || '' }}"
                  - key: "nginx*"
                    operator: Equals
                    value: "{{ element.image }}"
                  - key: "0"
                    operator: Equals
                    value: "{{ element.tag || 'none' }}"
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: mode-b-in
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: any-in
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: added NET_ADMIN
        foreach:
          - list: request.object.spec.initContainers
            deny:
              conditions:
                all:
                  - key: NET_ADMIN
                    operator: AnyIn
                    value: "{{ element.add || `[]` }}"
          - list: request.object.spec.containers
            deny:
              conditions:
                all:
                  - key: NET_ADMIN
                    operator: AnyIn
                    value: "{{ element.add || `[]` }}"
    - name: all-in
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: drop not ALL
        foreach:
          - list: request.object.spec.containers
            deny:
              conditions:
                all:
                  - key: "x-*"
                    operator: AllIn
                    value: "{{ element.add || `[]` }}"
    - name: not-in
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: not in
        foreach:
          - list: request.object.spec.containers
            deny:
              conditions:
                any:
                  - key: 5
                    operator: AnyNotIn
                    value: "{{ element.ports }}"
                  - key: a-b
                    operator: AllNotIn
                    value: "{{ element.command }}"
                  - key: true
                    operator: AnyIn
                    value: "{{ element.add || `[]` }}"
'''

_ADDS = ['NET_ADMIN', 'KILL', 'x-1', 'x-*', 'ALL', '*', 'NET_*', 'a-b',
         5, '5', 2.5, True, None]


def make_modeb_container(rng, i):
    c = {'name': rng.choice([f'c{i}', 'skipme', 'app']),
         'image': rng.choice(['nginx', 'nginx:1.25', 'nginx*', 'redis',
                              'ngin?', 'a-b'])}
    for key, pool in (
            ('securityContext', [{'privileged': True},
                                 {'privileged': False},
                                 {'privileged': 'true'}, {}]),
            ('port', [80, '80', 80.0, 8080, '80.0', True]),
            ('cpu', [0.5, '0.5', '500m', '0.50', 1, '5e-1']),
            ('timeout', ['30s', 30, '0.5m', 30.0, '30', '1h', '0', 'x',
                         '29.9999999999s', 3e10]),
            ('memory', ['1Gi', '1024Mi', '1073741824', 1073741824, '1G',
                        '0.0001m', 'abc']),
            ('tag', ['0', 0, '00', '0s', 'a']),
            ('add', [[rng.choice(_ADDS) for _ in range(rng.randint(0, 3))],
                     'NET_ADMIN', 'x-2', '[NET_ADMIN]', ' [a]', 'NET-ADMIN',
                     'x' * 70, 7, None,
                     [f'CAP_{k}' for k in range(40)]]),
            ('ports', [[5, 6], [6], ['5'], 5, '5', [], [None, 5]]),
            ('command', ['a-b', ['a-b'], ['c'], 'c', ' [x]', 'a*b'])):
        if rng.random() < 0.6:
            c[key] = rng.choice(pool)
    return c


def make_modeb_pod(rng, i):
    """A Pod for ``MODE_B_PACK``: values of every type under each
    element key, keys missing (notfound), null list elements, and one
    Pod in eight with 40 containers (past the widest gather)."""
    n = 40 if i % 8 == 7 else rng.randint(0, 4)
    containers = [make_modeb_container(rng, k) for k in range(n)]
    if containers and rng.random() < 0.2:
        containers.insert(rng.randrange(len(containers) + 1), None)
    spec = {'containers': containers}
    if rng.random() < 0.4:
        spec['initContainers'] = [make_modeb_container(rng, 9)
                                  for _ in range(rng.randint(1, 2))]
    return {'apiVersion': 'v1', 'kind': 'Pod',
            'metadata': {'name': f'b{i}', 'namespace': 'default'},
            'spec': spec}


# ---------------------------------------------------------------------------
# evaluators and batches

_PACK_SOURCES = {
    'mode_b': (MODE_B_PACK, make_modeb_pod),
    'foreach': (None, lambda rng, i: test_foreach_compile.make_pod(rng)),
    'admission_lanes': (smokepack.ADMISSION_LANES_PACK,
                        lambda rng, i: smokepack.make_config4_pod(rng, i)),
    'restricted': ('\n---\n'.join([smokepack.SMOKE_PACK,
                                   smokepack.RESTRICTED_FOREACH_PACK,
                                   smokepack.ADMISSION_LANES_PACK]),
                   smokepack.make_restricted_pod),
}
_EV = {}


def _policies(name):
    """(JAX-package policies, port policies) of ``name``."""
    if _PACK_SOURCES[name][0] is None:
        return load_pack(name)
    from kyverno_tpu.api.policy import Policy as JaxPolicy
    from kyverno_tpu_torch.api.policy import Policy as TorchPolicy
    docs = [d for d in yaml.safe_load_all(_PACK_SOURCES[name][0]) if d]
    return [JaxPolicy(d) for d in docs], [TorchPolicy(d) for d in docs]


def _evaluators(name):
    """(JAX cps, JAX evaluator, port cps, port evaluator) of ``name``."""
    if name not in _EV:
        from kyverno_tpu.compiler.compile import compile_policies as jcomp
        from kyverno_tpu.ops.eval import build_evaluator as jbuild
        from kyverno_tpu_torch.compiler.compile import \
            compile_policies as tcomp
        from kyverno_tpu_torch.ops.eval import build_evaluator as tbuild
        jp, tp = _policies(name)
        jc, tc = jcomp(jp), tcomp(tp)
        _EV[name] = (jc, jbuild(jc), tc, tbuild(tc, 'cpu'))
    return _EV[name]


def _docs(name, n, seed=7):
    rng = random.Random(seed)
    return [_PACK_SOURCES[name][1](rng, i) for i in range(n)]


def _adm_rows(n, seed):
    """``n`` admission tuples drawn from ``smokepack.ADMISSIONS`` (every
    subject, role, cluster-role and exclusion branch), a few without
    admission info."""
    rng = random.Random(seed)
    rows = [rng.choice(smokepack.ADMISSIONS) for _ in range(n)]
    for i in range(0, n, 7):
        rows[i] = (None, [], {}, 'CREATE')
    return rows


def _tensors(encode, admission, cps, evaluator, docs, cap, match, seed):
    """The batch tensors with the admission lanes of real tuples (the
    resource-shape atoms drawn at random: the host decides them)."""
    tensors = dict(encode(docs, cps, padded_n=cap).tensors())
    tensors['__match__'] = match[:cap]
    table = evaluator.adm_table
    if table is not None:
        lanes = admission.zero_lanes(table, cap)
        plan = admission.encode_rows(table, _adm_rows(len(docs), seed))
        for k, v in plan.lanes.items():
            lanes[k][:len(docs)] = v
        rng = np.random.default_rng(seed)
        lanes['__admres__'][:len(docs)] = \
            rng.random((len(docs), len(table.atoms))) < 0.8
        tensors.update(lanes)
    return tensors


def _three_ways(name, docs, monkeypatch, host_vm, seed=0):
    """out8/out32 of JAX, of the port's plain version and of the host
    build of K1v on the same batch."""
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu_torch.compiler import admission as tadm
    from kyverno_tpu_torch.compiler.encode import encode_batch as tencode
    jc, jev, tc, tev = _evaluators(name)
    rng = np.random.default_rng(seed)
    match = (rng.random((CAP, tev.n_uniq)) < 0.85).astype(np.uint8)
    jt = _tensors(jencode, jadm, jc, jev, docs, CAP, match, seed)
    tt = _tensors(tencode, tadm, tc, tev, docs, CAP, match, seed)
    j8, j32 = _run_jax(jev, jt)
    e8, e32 = _run_torch(tev, tt)
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        v8, v32 = _run_torch(tev, tt)
    return (j8, j32), (e8, e32), (v8, v32), tt


def _assert_equal(name, n, monkeypatch, host_vm, docs):
    (j8, j32), (e8, e32), (v8, v32), _ = _three_ways(name, docs,
                                                     monkeypatch, host_vm, n)
    assert e8.tobytes() == j8.tobytes(), 'eager walk vs JAX'
    assert e32.tobytes() == j32.tobytes(), 'eager walk vs JAX'
    assert v8.tobytes() == j8.tobytes(), 'K1v host build vs JAX'
    assert v32.tobytes() == j32.tobytes(), 'K1v host build vs JAX'


# ---------------------------------------------------------------------------
# the packs compile fully, and every tree and admission entry is on K1v

@pytest.mark.parametrize('name', sorted(_PACK_SOURCES))
def test_pack_compiles_fully_onto_k1v(name):
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, tev = _evaluators(name)
    assert tc.host_rules == []
    assert set(tev.routes) == set(range(len(tc.programs)))
    assert {r for r in tev.routes.values()} == {('vm', 'lowered')}
    tensors = dict(encode_batch(_docs(name, 8), tc, padded_n=8).tensors())
    if tev.adm_table is not None:
        from kyverno_tpu_torch.compiler.admission import zero_lanes
        tensors.update(zero_lanes(tev.adm_table, 8))
    _packed, layout = pack_batch(tensors)
    program = tev.plan_for(layout).program
    assert sorted(program.vm_cols) == list(range(tev.n_uniq))
    assert program.n_adm == tev.n_adm
    ops = [vm.OPS[c] for c in program.code[:, 0]]
    assert ops.count('AEND') == tev.n_adm
    # a status tree ends in one PEND per part, and one warp folds its
    # parts into its column
    assert sorted(program.tree_parts) == list(range(tev.n_uniq))
    assert ops.count('PEND') == sum(program.tree_parts.values())
    heads = program.warps[program.warps[:, 1] > 0]
    assert sorted(heads[:, 2].tolist()) == list(range(tev.n_uniq))
    assert heads[:, 1].tolist() == [program.tree_parts[c]
                                    for c in heads[:, 2].tolist()]
    if name != 'admission_lanes':
        assert ops.count('SFEBEGIN') >= 1


def test_admission_entries_need_the_admission_lanes():
    """Without the admission lanes (the mesh step's layout) the program
    carries no admission entry and K1v writes no admission column."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, tev = _evaluators('admission_lanes')
    _p, layout = pack_batch(encode_batch(_docs('admission_lanes', 4), tc,
                                         padded_n=4).tensors())
    program = tev.plan_for(layout).program
    assert program.n_adm == 0
    assert 'AEND' not in [vm.OPS[c] for c in program.code[:, 0]]


# ---------------------------------------------------------------------------
# byte-equal to JAX: the eager walk and the host build of K1v

@pytest.mark.parametrize('n', ROW_COUNTS)
def test_mode_b_pack_byte_equal_to_jax(n, jax_reference, host_vm,
                                       monkeypatch):
    _assert_equal('mode_b', n, monkeypatch, host_vm,
                  _docs('mode_b', max(ROW_COUNTS))[:n])


@pytest.mark.parametrize('n', ROW_COUNTS)
def test_admission_columns_byte_equal_to_jax(n, jax_reference, host_vm,
                                             monkeypatch):
    """Admission lanes from ``ADMISSIONS``: the trailing int8 columns of
    out8 (one per eligible program) equal JAX's, and they are not all
    alike (every branch decides some row)."""
    docs = _docs('admission_lanes', max(ROW_COUNTS))[:n]
    (j8, _j32), (e8, _e32), (v8, _v32), _tt = _three_ways(
        'admission_lanes', docs, monkeypatch, host_vm, n)
    _jc, _jev, tc, tev = _evaluators('admission_lanes')
    assert tev.n_adm == len(tev.adm_table.programs) >= 3
    assert e8.tobytes() == j8.tobytes() and v8.tobytes() == j8.tobytes()
    adm = v8[:n, 2 * tev.n_uniq:]
    assert adm.shape == (n, tev.n_adm)
    if n >= 63:
        assert (adm == 1).any(axis=0).all() and (adm == 0).any(axis=0).all()


@pytest.mark.parametrize('n', (1, 64, 65))
def test_restricted_configuration_byte_equal_to_jax(n, jax_reference,
                                                    host_vm, monkeypatch):
    """The slice's configuration: the smoke pack, the restricted chart's
    capability policies and the admission-lanes pack, over restricted
    Pods with admission lanes."""
    docs = _docs('restricted', 65, seed=3)[:n]
    _assert_equal('restricted', n, monkeypatch, host_vm, docs)


def _edge_pods():
    """Pods that reach each edge of the foreach walk: a null list
    element, a list past the gather width (overflow), a missing element
    key (notfound) on every element, on the last one only and on a
    middle one, an empty list, no list at all, an element list past the
    element gather width."""
    def c(name, **kw):
        return dict({'name': name, 'image': 'nginx'}, **kw)
    specs = [
        {'containers': [c('a', timeout='30s'), None, c('b', timeout='30s')]},
        {'containers': [None]},
        {'containers': [c(f'c{k}', timeout='30s') for k in range(40)]},
        {'containers': [c('a'), c('b')]},
        {'containers': [c('a', timeout='30s'), c('b')]},
        {'containers': [c('a'), c('b', timeout='30s')]},
        {'containers': [c('a', timeout='1s'), c('b', timeout='30s'),
                        c('z')]},
        {'containers': []},
        {},
        {'containers': [c('a', add=[f'C{k}' for k in range(40)])]},
        {'containers': [c('a', add=['NET_ADMIN', None, 'KILL'])],
         'initContainers': [None, c('i', add='NET_ADMIN')]},
        {'containers': [c('skipme', memory='1Gi'), c('skipme'),
                        c('a', memory='1Gi')]},
    ]
    return [{'apiVersion': 'v1', 'kind': 'Pod',
             'metadata': {'name': f'edge{i}', 'namespace': 'default'},
             'spec': s} for i, s in enumerate(specs)]


def test_foreach_edge_rows_byte_equal_to_jax(jax_reference, host_vm,
                                             monkeypatch):
    """Null elements, overflow, notfound gathers and an erroring last
    element, each present in the lanes, byte-equal to JAX."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import unpack_batch, pack_batch
    from kyverno_tpu_torch.compiler.ir import TAG_NULL
    docs = _edge_pods()
    _jc, _jev, tc, tev = _evaluators('mode_b')
    lanes = unpack_batch(*pack_batch(encode_batch(docs, tc, padded_n=16)
                                     .tensors()))
    lists = {f'g{tc.gathers.index(e.list_gather)}'
             for e in _foreach_entries(tc)}
    assert any((lanes[f'{g}_tag'] == TAG_NULL).any() for g in lists)
    assert any(lanes[f'{g}_overflow'].any() for g in lists)
    elem = sorted({k.split('_')[0] for k in lanes if k.startswith('e')})
    assert any(lanes[f'{e}_notfound'].any() for e in elem)
    assert any(lanes[f'{e}_overflow'].any() for e in elem)
    _assert_equal('mode_b', len(docs), monkeypatch, host_vm, docs)


# ---------------------------------------------------------------------------
# fuzzed lanes: the host build against the plain version

def _foreach_entries(tc):
    """Every foreach entry of the compiled programs."""
    def walk(node):
        if node is None:
            return
        if node.kind == 'foreach':
            yield from node.operand
        for c in node.children:
            yield from walk(c)
        yield from walk(node.sub)
    return [e for p in tc.programs for e in walk(p.status)]


def _fuzz_foreach(packed, layout, tc, table, seed):
    """``_fuzz_packed``, with each foreach list's count kept within its
    gather width (the eager walk's last-element gather indexes it) and
    the admission lanes redrawn: ids from the vocabulary and -1, random
    flags and atoms."""
    out = _fuzz_packed(packed, layout, seed)
    rng = np.random.default_rng(seed + 1000)
    for entry in _foreach_entries(tc):
        g = f'g{tc.gathers.index(entry.list_gather)}'
        buf, off, _w, _t = layout[f'{g}_count']
        out[buf][:, off] = np.clip(out[buf][:, off], 0,
                                   layout[f'{g}_tag'][3][-1])
    if table is not None:
        ids = np.array(sorted(table.vocab.values()) + [-1], np.int32)
        for name in vm.ADM_LANES:
            buf, off, width, _tail = layout[name]
            col = out[buf][:, off:off + width]
            if col.dtype == np.int32:
                col[:] = rng.choice(ids, col.shape)
            else:
                col[:] = rng.random(col.shape) < 0.5
    return out


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('name', sorted(_PACK_SOURCES))
def test_host_vm_equals_plain_on_fuzzed_lanes(name, seed, host_vm):
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.compiler.admission import zero_lanes
    from kyverno_tpu_torch.ops.eval import pack_batch
    _jc, _jev, tc, tev = _evaluators(name)
    tensors = dict(encode_batch(_docs(name, 96, seed=100 + seed), tc,
                                padded_n=96).tensors())
    if tev.adm_table is not None:
        tensors.update(zero_lanes(tev.adm_table, 96))
    packed, layout = pack_batch(tensors)
    fuzzed = _fuzz_foreach(packed, layout, tc, tev.adm_table, seed)
    program = tev.plan_for(layout).program
    want = program.plain({k: torch.from_numpy(v) for k, v in fuzzed.items()})
    got = run_host(host_vm, program, fuzzed)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the slice as a whole: the scanner over restricted Pods

def test_restricted_scan_matches_jax_and_host(jax_reference, host_vm,
                                              monkeypatch):
    """``scan_report_results`` of the port (K1v's host build in place of
    the card) against the JAX scanner and the host engine, over
    restricted Pods in several chunks."""
    from test_torch_scan import NOW, _host_rows, _port_scanner
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    jp, tp = _policies('restricted')
    pods = _docs('restricted', 130, seed=21)
    pods[5]['spec']['containers'] += [
        {'name': f'x{k}', 'image': 'nginx:1.25.3'} for k in range(40)]
    with monkeypatch.context() as m:
        _with_host_vm(m, host_vm)
        port = [(r, s, [p.name for p in ps]) for r, s, ps in
                _port_scanner(tp).scan_report_results(pods, now=NOW)]
    jsc = JaxScanner(jp)
    jsc.CHUNK = 64
    jsc._encoder_pool.procs = 0  # no fork of a process holding jax
    ref = [(r, s, [p.name for p in ps]) for r, s, ps in
           jsc.scan_report_results(pods, now=NOW)]
    assert port == ref
    host = _host_rows(jp, pods)
    assert [(r, s) for r, s, _ in port] == host


# ---------------------------------------------------------------------------
# the card build

@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_PACK_SOURCES))
def test_k1v_cuda_kernel_matches_plain_on_foreach_and_admission(name):
    """K1v on the card against its plain version (the eager walk and
    ``_adm_match_graph`` on the same card tensors), on encoded rows with
    admission lanes and on fuzzed lanes: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels have no '
                    'CPU mode (their plain versions are tested here)')
    from kyverno_tpu_torch.compiler.admission import zero_lanes
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, pack_batch
    cuda = torch.device('cuda')
    _jp, tp = _policies(name)
    tc = compile_policies(tp)
    ev = build_evaluator(tc, cuda)
    assert {r[0] for r in ev.routes.values()} == {'vm'}
    tensors = dict(encode_batch(_docs(name, 300), tc,
                                padded_n=320).tensors())
    if ev.adm_table is not None:
        tensors.update(zero_lanes(ev.adm_table, 320))
    packed, layout = pack_batch(tensors)
    program = ev.plan_for(layout).program
    for seed, bufs in enumerate(
            [packed] + [_fuzz_foreach(packed, layout, tc, ev.adm_table, s)
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
