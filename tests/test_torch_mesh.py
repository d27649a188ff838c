"""The port's multi-device scan (``kyverno_tpu_torch/parallel/mesh.py``)
against the JAX package's, on the CPU.

* K4h ``status_histogram`` — its plain version against the JAX step's
  reduction body (``jax.nn.one_hot`` + row mask + ``jnp.sum``) on
  numpy-seeded statuses, with codes outside ``[0, 6)``, every kind of row
  mask and empty shapes.  The kernel itself runs only on a CUDA card (the
  ``cuda`` test skips here).
* ``distributed_scan_step`` on a one-rank mesh, with no process group and
  with a gloo group of world size 1, against the JAX step on 1- and
  2-device meshes (``tests/conftest.py`` makes 8 virtual CPU devices).
* ``BatchScanner(mesh=...)`` against the port's single-device scanner and
  the JAX mesh scanner.
* Two ranks in two processes on gloo, against each other and the JAX
  2-device mesh; the fleet telemetry of the mesh path.

Every comparison is exact: the outputs are integers and status codes.
Every JAX call runs under ``x64_shim`` (``tests/test_torch_reference.py``).
"""

import datetime
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench
import test_parallel
from test_torch_reference import jax_reference, x64_shim  # noqa: F401

from kyverno_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CODES = 6
#: bound on each spawned rank, and on its rendezvous
WORKER_TIMEOUT_S = 240
INIT_TIMEOUT = datetime.timedelta(seconds=60)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the K4h kernel has no CPU mode '
                    '(its plain version is tested here)')
    return torch.device('cuda')


@pytest.fixture
def gloo1(tmp_path, monkeypatch):
    """A gloo process group of world size 1 in this process, rendezvous
    through a file under ``tmp_path``; destroyed after the test."""
    monkeypatch.setenv('GLOO_SOCKET_IFNAME', 'lo')
    store = dist.FileStore(str(tmp_path / 'gloo-store'), 1)
    dist.init_process_group('gloo', store=store, rank=0, world_size=1,
                            timeout=INIT_TIMEOUT)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fleet_off():
    from kyverno_tpu_torch import faults
    from kyverno_tpu_torch.observability import fleet
    yield fleet
    fleet.disable()
    faults.disable()


# ---------------------------------------------------------------------------
# K4h

def jax_histogram(statuses: np.ndarray, rowvalid, n_codes: int):
    """The JAX step's reduction (kyverno_tpu/parallel/mesh.py:70-74)."""
    with x64_shim():
        one_hot = jax.nn.one_hot(jnp.asarray(statuses), n_codes,
                                 dtype=jnp.int32)
        if rowvalid is not None:
            one_hot = one_hot * (jnp.asarray(rowvalid) != 0).astype(
                jnp.int32)[:, None, None]
        return np.asarray(jnp.sum(one_hot, axis=0))


def _k4_inputs(rows, cols, lo, hi, mask, seed):
    rng = np.random.default_rng(seed)
    statuses = rng.integers(lo, hi, (rows, cols)).astype(np.int8)
    rowvalid = {'absent': None,
                'zeros': np.zeros(rows, np.uint8),
                'mixed': (rng.random(rows) < 0.9).astype(np.uint8),
                'ones': np.ones(rows, np.uint8)}[mask]
    return statuses, rowvalid


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize('mask', ['absent', 'zeros', 'mixed', 'ones'])
@pytest.mark.parametrize('rows,cols,lo,hi', [
    (64, 13, 0, 6),        # the smoke pack's width, codes in range
    (300, 7, -2, 8),       # codes below and above the range
    (50, 40, -128, 128),   # every int8 value
    (0, 5, 0, 6),          # no rows
    (9, 0, 0, 6),          # no programs
])
def test_k4h_plain_matches_jax(rows, cols, lo, hi, mask):
    statuses, rowvalid = _k4_inputs(rows, cols, lo, hi, mask,
                                    seed=rows * 7 + cols)
    want = jax_histogram(statuses, rowvalid, N_CODES)
    got = kernels.status_histogram_plain(_t(statuses), _t(rowvalid),
                                         N_CODES)
    assert want.dtype == np.int64
    assert got.dtype == torch.int64
    assert got.shape == (cols, N_CODES)
    assert np.array_equal(got.numpy(), want)
    lib = kernels.status_histogram_library(_t(statuses), _t(rowvalid),
                                           N_CODES)
    assert torch.equal(lib, got)


def test_k4h_cpu_wrapper_takes_plain_and_counts_nothing():
    kernels.reset_launches()
    statuses, rowvalid = _k4_inputs(40, 9, -1, 7, 'mixed', seed=5)
    got = kernels.status_histogram(_t(statuses), _t(rowvalid), N_CODES)
    assert torch.equal(got, kernels.status_histogram_plain(
        _t(statuses), _t(rowvalid), N_CODES))
    assert kernels.LAUNCHES['k4_status_hist'] == 0


def test_k4h_wrapper_checks():
    statuses, rowvalid = _k4_inputs(8, 3, 0, 6, 'mixed', seed=2)
    with pytest.raises(ValueError):     # statuses must be int8
        kernels.status_histogram(_t(statuses).long(), None, N_CODES)
    with pytest.raises(ValueError):     # rowvalid must be uint8
        kernels.status_histogram(_t(statuses), _t(rowvalid).bool(),
                                 N_CODES)
    with pytest.raises(ValueError):     # rowvalid must have R entries
        kernels.status_histogram(_t(statuses), _t(rowvalid[:5]), N_CODES)
    with pytest.raises(ValueError):
        kernels.status_histogram(_t(statuses), None, 0)


def _strided(statuses, rowvalid, seed, device='cpu'):
    """The statuses as columns 3.. of a wider int8 buffer and the row
    mask as column 1 of a uint8 one, on ``device``: how the mesh step
    hands K4h a lane of its packed buffer."""
    rng = np.random.default_rng(seed)
    r, p = statuses.shape
    sbuf = rng.integers(-128, 128, (r, p + 7)).astype(np.int8)
    sbuf[:, 3:3 + p] = statuses
    st = torch.from_numpy(sbuf).to(device)[:, 3:3 + p]
    if rowvalid is None:
        return st, None
    rbuf = rng.integers(0, 256, (r, 5)).astype(np.uint8)
    rbuf[:, 1] = rowvalid
    return st, torch.from_numpy(rbuf).to(device)[:, 1]


@pytest.mark.parametrize('mask', ['absent', 'mixed'])
def test_k4h_cpu_wrapper_takes_strided_lanes(mask):
    statuses, rowvalid = _k4_inputs(300, 13, -2, 8, mask, seed=9)
    st, rv = _strided(statuses, rowvalid, seed=4)
    assert st.stride(0) == 20 and (rv is None or rv.stride(0) == 5)
    kernels.reset_launches()
    got = kernels.status_histogram(st, rv, N_CODES)
    assert np.array_equal(got.numpy(),
                          jax_histogram(statuses, rowvalid, N_CODES))
    assert torch.equal(got, kernels.status_histogram_plain(
        _t(statuses), _t(rowvalid), N_CODES))
    assert kernels.LAUNCHES['k4_status_hist'] == 0


@pytest.fixture(scope='module')
def k4_host(tmp_path_factory):
    """``k4_count_host`` of ``csrc/k4_count_host.cpp`` (K4h's counting
    step, ``csrc/k4_count.cuh``), built with g++."""
    import ctypes
    import shutil
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build csrc/k4_count_host.cpp (the CPU '
                    'build of K4h\'s counting step)')
    out = tmp_path_factory.mktemp('k4') / 'k4_count_host.so'
    proc = subprocess.run(
        [gxx, '-std=c++17', '-O1', '-shared', '-fPIC', '-o', str(out),
         os.path.join(REPO, 'kyverno_tpu_torch', 'csrc',
                      'k4_count_host.cpp')],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fn = ctypes.CDLL(str(out)).k4_count_host
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, ll, i, i, i, i, i, p]
    fn.restype = i
    return fn


@pytest.mark.parametrize('rows,cols,lo,hi,n_codes,q,threads,grid,mask', [
    (64, 13, 0, 6, 6, 1, 256, 1, 'mixed'),       # the step's width
    (300, 7, -2, 8, 6, 1, 32, 2, 'mixed'),       # codes either side
    (500, 40, -128, 128, 6, 4, 64, 3, 'absent'),  # every int8 value
    (2000, 37, -3, 9, 8, 4, 16, 2, 'mixed'),     # 8 codes, a 5-column edge
    (1000, 13, 0, 1, 1, 1, 256, 1, 'ones'),      # one code
    (70000, 5, 0, 6, 6, 1, 2, 1, 'mixed'),       # 70,000 steps: 275 rounds
    (16 * 256 + 1, 1, 2, 3, 6, 1, 1, 1, 'absent'),  # one code, 16 rounds
    (20, 4097, -2, 8, 6, 4, 256, 1, 'mixed'),    # two column tiles
    (33, 2100, -2, 8, 6, 1, 256, 2, 'zeros'),    # three tiles, all masked
    (1, 3, 0, 6, 6, 1, 256, 4, 'ones'),          # one row, blocks idle
])
def test_k4h_host_count_matches_plain(k4_host, rows, cols, lo, hi, n_codes,
                                      q, threads, grid, mask):
    """K4h's counting step (byte counters, their flush every 255 row
    steps, the reduction in 16-bit lanes, the column groups and tiles)
    on strided statuses and row masks, against the plain version."""
    statuses, rowvalid = _k4_inputs(rows, cols, lo, hi, mask,
                                    seed=rows + cols)
    st, rv = _strided(statuses, rowvalid, seed=cols)
    out = np.zeros((cols, n_codes), np.int64)
    rc = k4_host(st.data_ptr(), st.stride(0),
                 rv.data_ptr() if rv is not None else None,
                 rv.stride(0) if rv is not None else 0, rows, cols, n_codes,
                 q, threads, grid, out.ctypes.data)
    assert rc == 0
    want = kernels.status_histogram_plain(_t(statuses), _t(rowvalid),
                                          n_codes)
    assert np.array_equal(out, want.numpy())


@pytest.mark.cuda
def test_k4h_cuda_kernel_matches_plain(cuda):
    kernels.reset_launches()
    cases = [(16384, 13, 0, 6, 'mixed', N_CODES),     # the mesh step
             (131072, 256, -2, 8, 'mixed', N_CODES),  # random, 16-byte loads
             (5000, 2100, -2, 8, 'absent', N_CODES),  # three column tiles
             (777, 3, -128, 128, 'zeros', N_CODES),
             (1000, 1, -2, 8, 'mixed', N_CODES),      # P = 1
             (3000, 4097, -2, 8, 'mixed', N_CODES),   # P = 4,097
             (1, 13, 0, 6, 'ones', N_CODES),          # one row
             (16 * 256 + 1, 64, 3, 4, 'absent', N_CODES),  # one code
             (16383, 256, 0, 8, 'mixed', 8),          # 8 codes, ragged rows
             (4099, 17, -2, 12, 'mixed', 9),          # the shared-memory path
             (300, 5, -2, 100, 'mixed', kernels.K4_MAX_CODES),
             (0, 13, 0, 6, 'mixed', N_CODES), (64, 0, 0, 6, 'absent', N_CODES)]
    launched = 0
    for i, (rows, cols, lo, hi, mask, n_codes) in enumerate(cases):
        statuses, rowvalid = _k4_inputs(rows, cols, lo, hi, mask, seed=i)
        want = kernels.status_histogram_plain(_t(statuses), _t(rowvalid),
                                              n_codes)
        rv = _t(rowvalid).to(cuda) if rowvalid is not None else None
        got = kernels.status_histogram(_t(statuses).to(cuda), rv, n_codes)
        got_s = kernels.status_histogram(
            *_strided(statuses, rowvalid, seed=i, device=cuda), n_codes)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (rows, cols, mask, n_codes)
        assert torch.equal(got_s.cpu(), want), (rows, cols, mask, 'strided')
        launched += 2 * (rows > 0 and cols > 0)
    assert kernels.LAUNCHES['k4_status_hist'] == launched


@pytest.mark.cuda
def test_k4h_cuda_two_streams_keep_their_own_workspace(cuda):
    """Launches on two streams at once each end with their own
    histogram: the ticket and accumulator are per stream."""
    cases = [_k4_inputs(131072, 256, -2, 8, 'mixed', seed=s) for s in (1, 2)]
    dev = [(_t(st).to(cuda), _t(rv).to(cuda)) for st, rv in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(kernels.status_histogram(*dev[k], N_CODES))
    torch.cuda.synchronize()
    for k, (st, rv) in enumerate(cases):
        want = kernels.status_histogram_plain(_t(st), _t(rv), N_CODES)
        assert all(torch.equal(o.cpu(), want) for o in outs[k])


# ---------------------------------------------------------------------------
# distributed_scan_step

def _bench_case(n):
    rng = random.Random(0)
    return bench.PACK, [bench.make_pod(rng, i) for i in range(n)]


def _parallel_case(n):
    return test_parallel.PACK, test_parallel.pods(n)


CASES = {'bench': _bench_case, 'parallel': _parallel_case}


def _jax_step(pack, pods, n_dev):
    from kyverno_tpu.api.policy import load_policies_from_yaml
    from kyverno_tpu.compiler.compile import compile_policies
    from kyverno_tpu.parallel import mesh as jmesh
    with x64_shim():
        cps = compile_policies(load_policies_from_yaml(pack))
        statuses, summary = jmesh.distributed_scan_step(
            cps, jmesh.make_mesh(jax.devices()[:n_dev]), pods)
        return np.asarray(statuses), np.asarray(summary)


def _port_cps(pack):
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    from kyverno_tpu_torch.compiler.compile import compile_policies
    return compile_policies(load_policies_from_yaml(pack))


@pytest.mark.parametrize('n_dev', [1, 2])
@pytest.mark.parametrize('case,n', [('bench', 24), ('parallel', 13)])
def test_step_one_rank_no_group_matches_jax(jax_reference, case, n, n_dev):
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    pack, pods = CASES[case](n)
    want_s, want_sum = _jax_step(pack, pods, n_dev)
    mesh = make_mesh(device='cpu')
    assert mesh.group is None and mesh.world_size == 1
    got_s, got_sum = distributed_scan_step(_port_cps(pack), mesh, pods)
    assert got_s.dtype == want_s.dtype == np.int8
    assert got_s.tobytes() == want_s.tobytes()
    assert got_sum.dtype == want_sum.dtype == np.int64
    assert np.array_equal(got_sum, want_sum)
    assert int(got_sum.sum()) == n * got_s.shape[1]


@pytest.mark.parametrize('n_dev', [1, 2])
@pytest.mark.parametrize('case,n', [('bench', 24), ('parallel', 13)])
def test_step_gloo_world_one_matches_jax(jax_reference, gloo1, case, n,
                                         n_dev):
    from kyverno_tpu_torch.controllers.leaderelection import mesh_is_leader
    from kyverno_tpu_torch.observability import fleet
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    pack, pods = CASES[case](n)
    want_s, want_sum = _jax_step(pack, pods, n_dev)
    mesh = make_mesh(device='cpu')
    assert (mesh.group, mesh.backend, mesh.world_size) == (gloo1, 'gloo', 1)
    assert mesh.devices == ['cpu']
    got_s, got_sum = distributed_scan_step(_port_cps(pack), mesh, pods)
    assert got_s.tobytes() == want_s.tobytes()
    assert got_sum.dtype == np.int64
    assert np.array_equal(got_sum, want_sum)
    assert mesh_is_leader() is True
    assert fleet.identity()['process_index'] == 0


def test_step_calls_the_all_reduce_on_a_group_of_one(gloo1, monkeypatch):
    """As JAX's psum always runs over its mesh, a group of world size 1
    still all-reduces the summary; a mesh with no group does not."""
    from kyverno_tpu_torch.parallel.mesh import (Mesh, distributed_scan_step,
                                                 make_mesh)
    calls = []
    real = dist.all_reduce

    def spy(t, *args, **kwargs):
        calls.append(tuple(t.shape))
        return real(t, *args, **kwargs)

    monkeypatch.setattr(dist, 'all_reduce', spy)
    pack, pods = _bench_case(10)
    cps = _port_cps(pack)
    distributed_scan_step(cps, make_mesh(device='cpu'), pods)
    assert calls == [(len(cps.programs), N_CODES)]
    lone = Mesh(None, 0, 1, None, torch.device('cpu'), ['cpu'])
    distributed_scan_step(cps, lone, pods)
    assert len(calls) == 1


def test_step_matches_the_single_device_scan():
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    pack, pods = _parallel_case(13)
    policies = load_policies_from_yaml(pack)
    statuses, summary = distributed_scan_step(
        _port_cps(pack), make_mesh(device='cpu'), pods)
    single, _, _ = BatchScanner(policies, device='cpu').scan_statuses(pods)
    assert np.array_equal(statuses, single)
    expect = np.stack([(statuses == c).sum(axis=0)
                       for c in range(N_CODES)], axis=1)
    assert np.array_equal(summary, expect)


def test_mesh_rows_must_divide():
    from kyverno_tpu_torch.ops.eval import shard_batch
    from kyverno_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
    mesh = Mesh(None, 1, 2, None, torch.device('cpu'), ['cpu', 'cpu'])
    assert mesh.row_slice(8) == slice(4, 8)
    tensors = {'x': np.arange(14, dtype=np.int64).reshape(7, 2),
               'y': np.arange(7, dtype=np.int8)}
    with pytest.raises(ValueError, match='divide'):
        shard_batch(tensors, 'cpu', mesh=mesh)
    tensors = {k: np.concatenate([v, v[:1]]) for k, v in tensors.items()}
    out, _layout = shard_batch(tensors, 'cpu', mesh=mesh)
    assert out['pk_int64'].tolist() == [[8, 9], [10, 11], [12, 13],
                                        [0, 1]]
    assert out['pk_int8'].tolist() == [[4], [5], [6], [0]]
    assert pad_to_multiple(13, 8) == 16 and pad_to_multiple(16, 8) == 16


def test_make_mesh_needs_cuda_by_default(monkeypatch):
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh()
    assert make_mesh(device='cpu').device == torch.device('cpu')


# ---------------------------------------------------------------------------
# BatchScanner(mesh=...)

NOW = 1_700_000_000


def _scanner(policies, chunk, monkeypatch, **kwargs):
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    sc = BatchScanner(policies, **kwargs)
    sc.CHUNK = chunk
    return sc


def _rows(scanner, pods):
    return [(r, s, [p.name for p in ps])
            for r, s, ps in scanner.scan_report_results(pods, now=NOW)]


@pytest.mark.parametrize('n', [40, 10])
def test_mesh_scanner_matches_port_and_jax(jax_reference, monkeypatch, n):
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    from kyverno_tpu.parallel import mesh as jmesh
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    from test_torch_reference import load_pack, make_resources
    jpols, tpols = load_pack('smoke')
    pods = make_resources('smoke', n, seed=3)
    mesh_rows = _rows(_scanner(tpols, 16, monkeypatch, mesh=make_mesh(
        device='cpu'), device='cpu'), pods)
    single_rows = _rows(_scanner(tpols, 16, monkeypatch, device='cpu'), pods)
    jsc = JaxScanner(jpols, mesh=jmesh.make_mesh(jax.devices()[:2]))
    jsc.CHUNK = 16
    jsc._encoder_pool.procs = 0   # no fork of a process holding jax
    jax_rows = [(r, s, [p.name for p in ps])
                for r, s, ps in jsc.scan_report_results(pods, now=NOW)]
    assert len(mesh_rows) == n
    assert mesh_rows == single_rows
    assert mesh_rows == jax_rows


def test_mesh_scanner_scan_matches_single_device(gloo1, monkeypatch):
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    from test_torch_reference import load_pack, make_resources
    _jpols, tpols = load_pack('compiler')
    pods = make_resources('compiler', 37, seed=4)
    mesh_sc = _scanner(tpols, 16, monkeypatch, mesh=make_mesh(device='cpu'))
    assert mesh_sc.device == torch.device('cpu')
    single = _scanner(tpols, 16, monkeypatch, device='cpu')

    def table(responses):
        return [[(resp.policy_response.policy_name,
                  [(r.name, str(r.status), r.message)
                   for r in resp.policy_response.rules])
                 for resp in row] for row in responses]

    assert table(mesh_sc.scan(pods)) == table(single.scan(pods))
    warmed = mesh_sc.warmup_shapes()
    assert sorted(warmed) == [16, 64]


def test_mesh_scanner_device_must_be_the_ranks(monkeypatch):
    from kyverno_tpu_torch.parallel.mesh import Mesh
    from test_torch_reference import load_pack
    _jpols, tpols = load_pack('smoke')
    mesh = Mesh(None, 0, 1, None, torch.device('cpu'), ['cpu'])
    with pytest.raises(ValueError, match='mesh'):
        _scanner(tpols, 16, monkeypatch, mesh=mesh, device='meta')


def test_mesh_scan_with_partitions_stays_monolithic(monkeypatch):
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    from test_torch_reference import load_pack, make_resources
    _jpols, tpols = load_pack('smoke')
    monkeypatch.setenv('KTPU_PARTITIONS', '2')
    with pytest.raises(NotImplementedError):
        _scanner(tpols, 16, monkeypatch, device='cpu')
    sc = _scanner(tpols, 16, monkeypatch, mesh=make_mesh(device='cpu'))
    pods = make_resources('smoke', 5, seed=1)
    monkeypatch.delenv('KTPU_PARTITIONS')
    assert _rows(sc, pods) == _rows(
        _scanner(tpols, 16, monkeypatch, device='cpu'), pods)


# ---------------------------------------------------------------------------
# fleet telemetry on the mesh path

def _hist_series(reg, name):
    return {dict(key).get('shard'): (count, total)
            for key, count, total in reg.histogram_series(name)}


def test_fleet_records_mesh_dispatches(fleet_off, monkeypatch):
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    fleet = fleet_off
    pack, pods = _parallel_case(13)
    cps = _port_cps(pack)
    mesh = make_mesh(device='cpu')
    base = distributed_scan_step(cps, mesh, pods)
    reg = MetricsRegistry()
    assert fleet.configure(reg, profile_trigger=lambda: None) is not None
    on = distributed_scan_step(cps, mesh, pods)
    assert all(np.array_equal(a, b) for a, b in zip(base, on))
    assert set(_hist_series(reg, fleet.MESH_STEP_DURATION)) == {'0', 'all'}
    assert reg.counter_total(fleet.MESH_COLLECTIVE_SECONDS) >= 0.0
    assert fleet.MESH_COLLECTIVE_SECONDS in reg.snapshot()['counters']
    # 13 rows pad to the 64-row capacity
    assert reg.counter_total(fleet.MESH_PADDING_ROWS) == 64 - 13
    # the scanner's mesh dispatches record too, one per chunk
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    sc = _scanner(load_policies_from_yaml(pack), 16, monkeypatch,
                  mesh=mesh)
    sc.scan_statuses(test_parallel.pods(40))
    count, _total = _hist_series(reg, fleet.MESH_STEP_DURATION)['0']
    assert count == 1 + 3
    assert reg.counter_total(fleet.MESH_PADDING_ROWS) == 51 + 8
    assert reg.gauge_value(fleet.MESH_SHARD_SKEW, mesh='data1') == 1.0


def test_mesh_shard_fault_delay_inflates_the_shard_wall(fleet_off):
    from kyverno_tpu_torch import faults
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    fleet = fleet_off
    pack, pods = _parallel_case(9)
    cps = _port_cps(pack)
    mesh = make_mesh(device='cpu')
    distributed_scan_step(cps, mesh, pods)
    reg = MetricsRegistry()
    fleet.configure(reg, profile_trigger=lambda: None)
    faults.configure('site=mesh_shard,nth=2,delay_ms=200')
    distributed_scan_step(cps, mesh, pods)
    fast = reg.histogram_sum(fleet.MESH_STEP_DURATION, shard='0')
    distributed_scan_step(cps, mesh, pods)
    slow = reg.histogram_sum(fleet.MESH_STEP_DURATION, shard='0') - fast
    assert slow >= 0.2 > fast
    assert reg.histogram_sum(fleet.MESH_STEP_DURATION, shard='all') >= 0.2


def test_fleet_snapshots_round_trip_two_ranks(fleet_off, tmp_path,
                                              monkeypatch):
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    fleet = fleet_off
    pack, pods = _bench_case(24)
    cps = _port_cps(pack)
    mesh = make_mesh(device='cpu')
    docs = []
    for rank in (0, 1):
        reg = MetricsRegistry()
        fleet.configure(reg, profile_trigger=lambda: None)
        for _ in range(rank + 1):
            distributed_scan_step(cps, mesh, pods)
        monkeypatch.setattr(fleet, 'identity', lambda r=rank: {
            'host': 'h', 'pid': 100 + r, 'process_index': r})
        path = tmp_path / f'rank{rank}.jsonl'
        docs.append(fleet.write_snapshot(str(path), reg))
    read = fleet.read_snapshot_files(
        [str(tmp_path / f'rank{r}.jsonl') for r in (0, 1)])
    assert read == json.loads(json.dumps(docs))
    merged = fleet.FleetRegistry.merge(read)
    assert [i['process_index'] for i in merged['identities']] == [0, 1]
    totals = [fleet.FleetRegistry.counter_totals(d) for d in read]
    merged_totals = fleet.FleetRegistry.counter_totals(merged)
    assert set(merged_totals) == set(totals[0]) | set(totals[1])
    for name, value in merged_totals.items():
        assert value == pytest.approx(totals[0].get(name, 0.0) +
                                      totals[1].get(name, 0.0))
    assert merged_totals[fleet.MESH_PADDING_ROWS] == 3 * (64 - 24)
    [(_key, count, _sum, _b)] = [
        e for e in merged['hists'][fleet.MESH_STEP_DURATION]['series']
        if dict(map(tuple, e[0]))['shard'] == '0']
    assert count == 3
    # the merge of per-rank merges is the flat merge
    assert fleet.FleetRegistry.merge(
        [fleet.FleetRegistry.merge([d]) for d in read]) == merged


def test_sustained_skew_fires_the_ports_deep_profile(tmp_path, monkeypatch):
    """The straggler auto-profile reaches ``profiling.deep_profile`` of
    the port (no card here: a sampling profile without a torch trace)."""
    from kyverno_tpu_torch.observability import fleet, profiling
    monkeypatch.setenv('KTPU_PROFILE_DIR', str(tmp_path))
    an = fleet.SkewAnalyzer(window=2)
    an.fold('data3', [0.01, 0.01, 0.09], ['a', 'b', 'c'])
    verdict = an.fold('data3', [0.01, 0.01, 0.09], ['a', 'b', 'c'])
    assert verdict['sustained'] and verdict['device'] == 'c'
    deadline = time.monotonic() + 30
    found = []
    while not found and time.monotonic() < deadline:
        found = [d for d in os.listdir(tmp_path)
                 if os.path.exists(tmp_path / d / 'py.folded')]
        time.sleep(0.05)
    assert found and found[0].startswith('profile-mesh_skew-')
    res = profiling.deep_profile(seconds=0.05, out_dir=str(tmp_path))
    assert res['torch_trace'] is False
    assert res['artifacts'] == ['py.folded']


# ---------------------------------------------------------------------------
# two ranks, two processes, gloo

WORKER = r'''
import datetime, hashlib, json, os, random, sys
sys.path.insert(0, %(repo)r)
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group(
    'gloo', store=dist.FileStore(%(store)r, 2), rank=rank, world_size=2,
    timeout=datetime.timedelta(seconds=60))
import numpy as np
import bench
from kyverno_tpu_torch.api.policy import load_policies_from_yaml
from kyverno_tpu_torch.compiler.compile import compile_policies
from kyverno_tpu_torch.compiler.scan import BatchScanner
from kyverno_tpu_torch.controllers.leaderelection import mesh_is_leader
from kyverno_tpu_torch.observability import fleet
from kyverno_tpu_torch.observability.metrics import MetricsRegistry
from kyverno_tpu_torch.parallel.mesh import distributed_scan_step, make_mesh
from kyverno_tpu_torch.reports.results import get_results, set_responses
from kyverno_tpu_torch.reports.types import new_background_scan_report

reg = MetricsRegistry()
fleet.configure(reg, profile_trigger=lambda: None)
policies = load_policies_from_yaml(bench.PACK)
cps = compile_policies(policies)
rng = random.Random(0)
resources = [bench.make_pod(rng, i) for i in range(24)]
mesh = make_mesh(device='cpu')
statuses, summary = distributed_scan_step(cps, mesh, resources)
stream_resources = [bench.make_pod(rng, 1000 + i) for i in range(40)]
scanner = BatchScanner(policies, mesh=mesh)
report_dump = []
for resource, responses in zip(stream_resources,
                               scanner.scan_stream(stream_resources)):
    report = new_background_scan_report(resource)
    relevant = [r for r in responses if r.policy_response.rules]
    set_responses(report, *relevant, now=0)
    report.setdefault('spec', {})['results'] = [
        {k: v for k, v in res.items() if k != 'timestamp'}
        for res in get_results(report)]
    report_dump.append(report)
fleet.write_snapshot(os.path.join(%(out)r, 'fleet-%%d.jsonl' %% rank), reg)
print('RESULT ' + json.dumps({
    'rank': mesh.rank, 'world_size': mesh.world_size, 'backend': mesh.backend,
    'devices': mesh.devices, 'leader': mesh_is_leader(),
    'process_index': fleet.identity()['process_index'],
    'summary': summary.tolist(), 'summary_dtype': str(summary.dtype),
    'statuses': hashlib.sha256(statuses.tobytes()).hexdigest(),
    'status_shape': list(statuses.shape),
    'status_sum': int(statuses.astype(np.int64).sum()),
    'n_stream_reports': len(report_dump),
    'report_hash': hashlib.sha256(json.dumps(
        report_dump, sort_keys=True).encode()).hexdigest()}), flush=True)
dist.destroy_process_group()
'''


def _report_hash(scanner_cls_scan_stream, stream_resources):
    from kyverno_tpu.reports.results import get_results, set_responses
    from kyverno_tpu.reports.types import new_background_scan_report
    dump = []
    for resource, responses in zip(stream_resources,
                                   scanner_cls_scan_stream(stream_resources)):
        report = new_background_scan_report(resource)
        relevant = [r for r in responses if r.policy_response.rules]
        set_responses(report, *relevant, now=0)
        report.setdefault('spec', {})['results'] = [
            {k: v for k, v in res.items() if k != 'timestamp'}
            for res in get_results(report)]
        dump.append(report)
    return hashlib.sha256(json.dumps(dump, sort_keys=True).encode()
                          ).hexdigest()


def test_two_gloo_ranks_agree_with_each_other_and_jax(jax_reference,
                                                      tmp_path):
    code = WORKER % {'repo': REPO, 'store': str(tmp_path / 'store'),
                     'out': str(tmp_path)}
    env = dict(os.environ)
    env.update({'KTPU_SCAN_CHUNK': '16',    # 40 resources -> 3 chunks
                'KTPU_ENCODE_PROCS': '0', 'GLOO_SOCKET_IFNAME': 'lo'})
    procs = [subprocess.Popen([sys.executable, '-c', code, str(i)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f'rank failed:\n{err[-3000:]}'
            [line] = [ln for ln in out.splitlines()
                      if ln.startswith('RESULT ')]
            outs.append(json.loads(line[len('RESULT '):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    by_rank = {o['rank']: o for o in outs}
    assert set(by_rank) == {0, 1}
    r0, r1 = by_rank[0], by_rank[1]
    assert r0['leader'] is True and r1['leader'] is False
    for rank, o in by_rank.items():
        assert (o['world_size'], o['backend']) == (2, 'gloo')
        assert o['devices'] == ['cpu', 'cpu']
        assert o['process_index'] == rank
        assert o['summary_dtype'] == 'int64'
        assert o['status_shape'] == [24, 2]
        assert o['n_stream_reports'] == 40
    for key in ('summary', 'statuses', 'status_sum', 'report_hash'):
        assert r0[key] == r1[key], key

    # the JAX 2-device mesh on the same batch and stream
    from kyverno_tpu.api.policy import load_policies_from_yaml
    from kyverno_tpu.compiler.compile import compile_policies
    from kyverno_tpu.compiler.scan import BatchScanner as JaxScanner
    from kyverno_tpu.parallel import mesh as jmesh
    policies = load_policies_from_yaml(bench.PACK)
    rng = random.Random(0)
    resources = [bench.make_pod(rng, i) for i in range(24)]
    jm = jmesh.make_mesh(jax.devices()[:2])
    s, summary = jmesh.distributed_scan_step(compile_policies(policies), jm,
                                             resources)
    s = np.asarray(s)
    assert r0['summary'] == np.asarray(summary).tolist()
    assert r0['statuses'] == hashlib.sha256(s.tobytes()).hexdigest()
    assert r0['status_sum'] == int(s.astype(np.int64).sum())
    stream_resources = [bench.make_pod(rng, 1000 + i) for i in range(40)]
    jsc = JaxScanner(policies, mesh=jm)
    jsc.CHUNK = 16
    jsc._encoder_pool.procs = 0
    assert r0['report_hash'] == _report_hash(jsc.scan_stream,
                                             stream_resources)

    # the two ranks' fleet snapshots federate losslessly
    from kyverno_tpu_torch.observability import fleet
    docs = fleet.read_snapshot_files(
        [str(tmp_path / f'fleet-{r}.jsonl') for r in (0, 1)])
    assert sorted(d['identity']['process_index'] for d in docs) == [0, 1]
    merged = fleet.FleetRegistry.merge(docs)
    per = [fleet.FleetRegistry.counter_totals(d) for d in docs]
    for name, value in fleet.FleetRegistry.counter_totals(merged).items():
        assert value == pytest.approx(per[0].get(name, 0.0) +
                                      per[1].get(name, 0.0))
    shards = {dict(map(tuple, e[0]))['shard']
              for e in merged['hists'][fleet.MESH_STEP_DURATION]['series']}
    assert shards == {'0', '1', 'all'}
