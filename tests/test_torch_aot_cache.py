"""The port's compile cache and warm-up (``kyverno_tpu_torch/aotcache/``,
``compiler/aot.py``, the kernels' library directory in ``ops/_build.py``).

The JAX package's ``tests/test_aot_cache.py`` cases on the port's store,
keys, warmer and ``/health/warmup``, and what the port's seam adds: a K1v
program stored and loaded back runs to the same bytes (plain version and
the interpreter's host build), the key follows the pack layout but not
its row count, a stored program whose meta does not match is rejected, a
loaded program whose launch fails is evicted, and a second process loads
every program instead of lowering it, with the same out8/out32 as the
first process, an uncached one and the JAX evaluator.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kyverno_tpu_torch.aotcache import keys as aot_keys
from kyverno_tpu_torch.aotcache.store import AotStore, reset_default_store
from kyverno_tpu_torch.aotcache.warmer import Warmer
from kyverno_tpu_torch.compiler import aot
from kyverno_tpu_torch.observability import executables
from kyverno_tpu_torch.observability.metrics import (MetricsRegistry,
                                                     set_global_registry)
from kyverno_tpu_torch.ops import _build
from test_torch_eval import _run_jax, _tensors
from test_torch_reference import jax_reference, load_pack, make_resources  # noqa: F401
from test_torch_vm import host_vm, run_host  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REJECTED = 'kyverno_tpu_aot_load_rejected_total'


@pytest.fixture(autouse=True)
def _isolate_default_store(tmp_path, monkeypatch):
    """Every case gets its own store directory (the default is the
    repository's ``.cache/aot``, shared by every process)."""
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    monkeypatch.delenv('KTPU_AOT', raising=False)
    reset_default_store()
    yield
    aot.flush_stores()
    reset_default_store()
    set_global_registry(None)
    executables.disable()


# ---------------------------------------------------------------------------
# store


class TestStore:
    def test_miss_then_hit(self, tmp_path):
        store = AotStore(root=str(tmp_path))
        assert store.load('k' * 32) is None          # miss
        assert store.put('k' * 32, b'payload-bytes')
        assert store.load('k' * 32) == b'payload-bytes'  # hit
        st = store.stats()
        assert st['entries'] == 1 and st['bytes'] > len(b'payload-bytes')

    def test_corrupt_entry_dropped_not_crashed(self, tmp_path):
        store = AotStore(root=str(tmp_path))
        store.put('deadbeef', b'x' * 256)
        path = store.path('deadbeef')
        raw = bytearray(open(path, 'rb').read())
        raw[-1] ^= 0xFF  # flip a payload bit under the digest
        open(path, 'wb').write(bytes(raw))
        assert store.load('deadbeef') is None
        assert not os.path.exists(path), 'corrupt entry must be deleted'
        open(store.path('cafe'), 'wb').write(b'KT')
        assert store.load('cafe') is None
        assert not os.path.exists(store.path('cafe'))

    def test_lru_eviction_respects_byte_budget(self, tmp_path):
        blob = b'z' * 1000
        frame = 38  # magic + sha256
        store = AotStore(root=str(tmp_path),
                         max_bytes=3 * (len(blob) + frame))
        now = time.time()
        for i, key in enumerate(('old', 'mid', 'new')):
            store.put(key, blob)
            os.utime(store.path(key), (now - 100 + i, now - 100 + i))
        store.put('newest', blob)  # over budget: LRU ('old') evicted
        assert store.load('old') is None
        assert store.load('mid') is not None
        assert store.load('newest') is not None
        assert store.stats()['entries'] == 3

    def test_load_refreshes_lru_position(self, tmp_path):
        blob = b'z' * 1000
        store = AotStore(root=str(tmp_path), max_bytes=3 * 1100)
        now = time.time()
        for i, key in enumerate(('a', 'b', 'c')):
            store.put(key, blob)
            os.utime(store.path(key), (now - 100 + i, now - 100 + i))
        store.load('a')
        store.put('d', blob)
        assert store.load('b') is None
        assert store.load('a') is not None

    def test_atomic_writes_leave_no_tmp(self, tmp_path):
        store = AotStore(root=str(tmp_path))
        for i in range(5):
            store.put(f'key{i}', os.urandom(2048))
        assert not [n for n in os.listdir(tmp_path) if n.endswith('.tmp')]

    def test_env_knobs(self, tmp_path, monkeypatch):
        monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'via-env'))
        assert AotStore().root == str(tmp_path / 'via-env')
        monkeypatch.setenv('KTPU_AOT', '0')
        assert not AotStore().enabled

    def test_publishes_size_gauges(self, tmp_path):
        reg = MetricsRegistry()
        set_global_registry(reg)
        store = AotStore(root=str(tmp_path))
        store.put('k1', b'x' * 100)
        assert reg.gauge_value('kyverno_tpu_aot_cache_entries') == 1.0
        assert reg.gauge_value('kyverno_tpu_aot_cache_size_bytes') > 100

    def test_undecodable_blob_is_evicted_by_loader(self, tmp_path):
        store = AotStore(root=str(tmp_path))
        store.put('badcodec', b'Qnot-a-real-codec-blob')
        assert aot.load_executable('badcodec', store=store) is None
        assert store.load('badcodec') is None, 'bad entry must be dropped'


# ---------------------------------------------------------------------------
# keys


def _packed(rows, widths=(8, 2)):
    return {'pk_int8': torch.zeros((rows, widths[0]), dtype=torch.int8),
            'pk_float64': torch.zeros((rows, widths[1]),
                                      dtype=torch.float64)}


class TestKeys:
    def test_key_scopes_policy_set_and_version(self, monkeypatch):
        k1 = aot_keys.executable_cache_key('fp-one', _packed(4))
        k2 = aot_keys.executable_cache_key('fp-two', _packed(4))
        assert k1 and k2 and k1 != k2
        monkeypatch.setattr(aot_keys, 'AOT_VERSION',
                            aot_keys.AOT_VERSION + 1)
        k1_v2 = aot_keys.executable_cache_key('fp-one', _packed(4))
        assert k1_v2 and k1_v2 != k1

    def test_version_mismatch_misses_in_store(self, tmp_path, monkeypatch):
        store = AotStore(root=str(tmp_path))
        k_old = aot_keys.executable_cache_key('fp', _packed(4))
        store.put(k_old, b'serialized-under-old-version')
        monkeypatch.setattr(aot_keys, 'AOT_VERSION',
                            aot_keys.AOT_VERSION + 1)
        k_new = aot_keys.executable_cache_key('fp', _packed(4))
        assert store.load(k_new) is None
        assert store.load(k_old) is not None

    def test_key_follows_the_layout_not_the_row_count(self):
        """One K1v program serves every row count of its layout."""
        key = aot_keys.executable_cache_key
        assert key('fp', _packed(4)) == key('fp', _packed(16384))
        assert key('fp', _packed(4)) != key('fp', _packed(4, (9, 2)))
        assert key('fp', _packed(4), extra=('a',)) != \
            key('fp', _packed(4), extra=('b',))

    def test_key_is_none_when_disabled(self, monkeypatch):
        monkeypatch.setenv('KTPU_AOT', '0')
        assert aot_keys.executable_cache_key('fp', _packed(4)) is None

    def test_key_is_none_in_a_group_of_several_ranks(self, monkeypatch):
        monkeypatch.setattr(aot_keys, '_distributed_world', lambda: 2)
        assert aot_keys.executable_cache_key('fp', _packed(4)) is None
        monkeypatch.setattr(aot_keys, '_distributed_world', lambda: 1)
        assert aot_keys.executable_cache_key('fp', _packed(4))

    def test_key_is_none_on_an_exception(self):
        assert aot_keys.executable_cache_key('fp', {'x': object()}) is None

    def test_fingerprint_stable(self):
        fp = aot_keys.policy_set_fingerprint
        a = [{'spec': {'rules': [1]}, 'metadata': {'name': 'x'}}]
        b = [{'metadata': {'name': 'x'}, 'spec': {'rules': [1]}}]
        assert fp(a) == fp(b)
        assert fp(a) != fp([{'metadata': {'name': 'y'}}])

    def test_source_digest_reads_the_ports_sources(self):
        files = aot_keys.source_files()
        for rel in files:
            assert os.path.isfile(os.path.join(REPO, 'kyverno_tpu_torch',
                                               rel)), rel
        assert {'ops/eval.py', 'ops/vm.py', 'ops/kernels.py',
                'compiler/compile.py', 'compiler/encode.py',
                'compiler/ir.py', 'compiler/pss_compile.py',
                'compiler/admission.py', 'engine/pattern.py',
                'utils/quantity.py', 'csrc/k1_vm.cu', 'csrc/k1_vm.cuh',
                'csrc/glob_dp.cuh'} <= set(files)
        assert len(aot_keys.source_digest()) == 16

    def test_env_scope_creates_no_cuda_context(self):
        scope = aot_keys.env_scope()
        assert scope[1] == torch.__version__
        if not torch.cuda.is_initialized():
            assert scope[3] == ('cpu',) and scope[4] == ()
            assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# the kernels' library directory


class TestLibraryDirectory:
    def test_digest_changes_with_the_compiler_version(self, monkeypatch):
        def no_process(*a, **k):
            raise AssertionError('no nvcc call on the CPU')
        monkeypatch.setattr(subprocess, 'run', no_process)
        monkeypatch.setattr(subprocess, 'Popen', no_process)
        paths = {}
        for version in ('release 12.8', 'release 12.9'):
            monkeypatch.setattr(_build, 'nvcc_version', lambda v=version: v)
            paths[version] = {n: _build.library_path(n)
                              for n in _build.KERNELS}
        a, b = paths.values()
        assert all(a[n] != b[n] for n in _build.KERNELS)
        monkeypatch.setattr(_build, 'nvcc_version', lambda: 'release 12.8')
        assert {n: _build.library_path(n) for n in _build.KERNELS} == a

    def test_directory_follows_the_variable(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, 'nvcc_version', lambda: 'v')
        monkeypatch.delenv('KTPU_COMPILE_CACHE', raising=False)
        assert _build.build_dir() == _build.BUILD_DIR
        lib = str(tmp_path / 'lib')
        monkeypatch.setenv('KTPU_COMPILE_CACHE', lib)
        assert _build.build_dir() == lib
        assert aot_keys.enable_persistent_compilation_cache() == lib
        assert os.path.dirname(_build.library_path('k1_vm')) == lib
        with open(os.path.join(lib, aot_keys.HOSTKEY_FILE)) as f:
            assert f.read() == aot_keys.host_fingerprint()

    def test_directory_of_another_host_is_rescoped(self, tmp_path,
                                                   monkeypatch):
        reg = MetricsRegistry()
        set_global_registry(reg)
        lib = tmp_path / 'shared'
        lib.mkdir()
        (lib / aot_keys.HOSTKEY_FILE).write_text('another-host')
        monkeypatch.setenv('KTPU_COMPILE_CACHE', str(lib))
        got = _build.build_dir()
        assert got == str(lib / f'feat-{aot_keys.host_fingerprint()}')
        assert reg.counter_value(REJECTED, reason='feature_mismatch') == 1

    def test_build_log_is_the_one_of_the_build_that_made_the_library(
            self, tmp_path, monkeypatch):
        """Each process writes its compiler output under a name of its
        own and renames it beside the library it made, so a concurrent
        build in a shared directory cannot clobber the log read."""
        monkeypatch.setattr(_build, 'nvcc_version', lambda: 'v')
        monkeypatch.setenv('KTPU_COMPILE_CACHE', str(tmp_path / 'lib'))
        lib = _build.library_path('k1_vm')
        assert _build.build_log('k1_vm') == ''
        with open(f'{lib}.123.456.tmp.log', 'w') as f:
            f.write('ptxas info : another process, still building')
        assert _build.build_log('k1_vm') == ''
        with open(_build._log_path(lib), 'w') as f:
            f.write('ptxas info : Used 79 registers')
        assert _build.build_log('k1_vm') == 'ptxas info : Used 79 registers'


# ---------------------------------------------------------------------------
# warmer


class TestWarmer:
    def test_noop_when_disabled(self, monkeypatch):
        monkeypatch.setenv('KTPU_WARM', '0')
        calls = []
        w = Warmer(lambda: calls.append(1))
        assert w.start() is False
        assert w.state == 'disabled'
        assert w.wait(0.1) is True
        assert not calls
        assert not [t for t in threading.enumerate()
                    if t.name.startswith('ktpu-aot-warmer')]

    def test_ready_records_duration_histogram(self):
        reg = MetricsRegistry()
        w = Warmer(lambda: 'warmed 3 programs', registry=reg, enabled=True)
        assert w.start() is True
        assert w.wait(10.0)
        assert w.state == 'ready' and w.ready
        assert w.detail == 'warmed 3 programs'
        assert reg.histogram_count('kyverno_tpu_aot_warm_duration_seconds',
                                   target='admission', state='ready') == 1

    def test_failure_is_contained(self):
        reg = MetricsRegistry()

        def boom():
            raise RuntimeError('no card')
        w = Warmer(boom, name='scan', registry=reg, enabled=True)
        w.run_sync()
        assert w.state == 'failed' and not w.ready
        assert 'no card' in w.error
        assert reg.histogram_count('kyverno_tpu_aot_warm_duration_seconds',
                                   target='scan', state='failed') == 1

    def test_start_is_idempotent(self):
        calls = []
        w = Warmer(lambda: calls.append(1) or 'ok', enabled=True)
        assert w.start() and w.start()
        w.wait(10.0)
        assert calls == [1]

    def test_setup_starts_warmer(self):
        from kyverno_tpu_torch.cmd.internal import Setup
        setup = Setup('t', args=['--disable-metrics'])
        w = setup.start_aot_warmer(lambda: 'scanner serving')
        assert setup.aot_warmer is w
        assert w.wait(10.0) and w.state == 'ready'
        assert w.detail == 'scanner serving'

    def test_webhook_warmup_status(self):
        from types import SimpleNamespace
        from kyverno_tpu_torch.webhooks.server import WebhookServer
        status = WebhookServer.warmup_status
        body, code = status(SimpleNamespace(warmer=None))
        assert (body['state'], code) == ('disabled', 200)
        w = Warmer(lambda: 'ok', enabled=True)
        body, code = status(SimpleNamespace(warmer=w))
        assert (body['state'], code) == ('pending', 503)
        w.run_sync()
        body, code = status(SimpleNamespace(warmer=w))
        assert (body['state'], code) == ('ready', 200)
        assert 'duration_s' in body


# ---------------------------------------------------------------------------
# K1v programs through the store

N_DOCS, CAP = 40, 64


def _smoke_inputs():
    """(port policies, docs, match plane) of the smoke pack."""
    _jpols, tpols = load_pack('smoke')
    docs = make_resources('smoke', N_DOCS)
    return tpols, docs


def _evaluator_and_batch(tpols, docs):
    from kyverno_tpu_torch.compiler import admission
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    cps = compile_policies(tpols)
    ev = build_evaluator(cps, 'cpu')
    rng = np.random.default_rng(3)
    match = (rng.random((CAP, ev.n_uniq)) < 0.85).astype(np.uint8)
    tensors = _tensors(encode_batch, admission.zero_lanes, cps, ev, docs,
                       CAP, match)
    packed, layout = shard_batch(tensors, 'cpu')
    return ev, packed, layout


def _out(ev, packed, layout):
    out8, out32 = ev(packed, layout)
    return out8.numpy().tobytes(), out32.numpy().tobytes()


def test_program_round_trip_through_the_store(host_vm):  # noqa: F811
    """A stored and reloaded K1v program has the tables of the one
    lowered, no device tables and a plain version from its new
    evaluator; its plain output and its host build's output are
    byte-equal to the unstored program's."""
    from kyverno_tpu_torch.ops import kernels
    tpols, docs = _smoke_inputs()
    ev1, packed, layout = _evaluator_and_batch(tpols, docs)
    want = _out(ev1, packed, layout)
    plan1 = ev1.plan_for(layout)
    assert plan1.source == 'fresh_compile' and plan1.aot_key
    aot.flush_stores()
    blob_program = aot.decode_executable(
        aot.default_store().load(plan1.aot_key))
    assert blob_program._dev == {} and not hasattr(blob_program, 'plain')

    ev2, packed2, layout2 = _evaluator_and_batch(tpols, docs)
    plan2 = ev2.plan_for(layout2, packed2)
    assert plan2.source == 'aot_load'
    p1, p2 = plan1.program, plan2.program
    for name in ('code', 'lanes', 'i64', 'f64', 'bytes', 'warps', 'groups'):
        assert np.array_equal(getattr(p1, name), getattr(p2, name)), name
    assert p2.layout == p1.layout and p2.tree_parts == p1.tree_parts
    assert p2.plain is not p1.plain
    assert _out(ev2, packed2, layout2) == want
    for a, b in zip(kernels.status_vm(packed, p1),
                    kernels.status_vm(packed2, p2)):
        assert torch.equal(a, b)
    for a, b in zip(run_host(host_vm, p1, packed),
                    run_host(host_vm, p2, packed2)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize('setting,value', [('PART_INSNS', 1),
                                             ('LOCALS', 3)])
def test_a_lowering_setting_names_another_program(monkeypatch, setting,
                                                  value):
    """A program lowered under other settings of ``ops/vm.py`` (or with
    other trees routed to K1v) is never loaded in their place: the key
    holds them, so the evaluator lowers its own."""
    from kyverno_tpu_torch.ops import vm
    tpols, docs = _smoke_inputs()
    ev1, packed, layout = _evaluator_and_batch(tpols, docs)
    want = _out(ev1, packed, layout)
    stored = ev1.plan_for(layout).program
    aot.flush_stores()
    monkeypatch.setattr(vm, setting, value)
    ev2, packed2, layout2 = _evaluator_and_batch(tpols, docs)
    assert _out(ev2, packed2, layout2) == want
    plan2 = ev2.plan_for(layout2)
    assert plan2.source == 'fresh_compile'
    assert plan2.aot_key != ev1.plan_for(layout).aot_key
    if setting == 'PART_INSNS':
        assert plan2.program.tree_parts != stored.tree_parts


@pytest.mark.parametrize('field,reason', [
    ('host_features', 'feature_mismatch'),
    ('env_scope', 'env_mismatch'),
    ('torch', 'torch_mismatch')])
def test_meta_mismatch_is_rejected(field, reason):
    """A program stored under another host, environment or torch build
    is dropped and counted, and the evaluator lowers afresh."""
    reg = MetricsRegistry()
    set_global_registry(reg)
    tpols, docs = _smoke_inputs()
    ev1, packed, layout = _evaluator_and_batch(tpols, docs)
    want = _out(ev1, packed, layout)
    key = ev1.plan_for(layout).aot_key
    aot.flush_stores()
    store = aot.default_store()
    state, meta = aot._unpack_blob(store.load(key))
    wrong = ('0.0', None) if field == 'torch' else 'elsewhere'
    store.put(key, aot._pack_blob(state, dict(meta, **{field: wrong})))
    assert aot.load_executable(key) is None
    assert store.load(key) is None
    assert reg.counter_value(REJECTED, reason=reason) == 1
    ev2, packed2, layout2 = _evaluator_and_batch(tpols, docs)
    assert _out(ev2, packed2, layout2) == want
    assert ev2.plan_for(layout2).source == 'fresh_compile'


def test_failed_launch_of_a_loaded_program_evicts_it(monkeypatch):
    """The launch's error propagates (no plain version in its place),
    and the entry leaves memory and the store, so the next call lowers
    afresh."""
    from kyverno_tpu_torch.ops import kernels
    reg = MetricsRegistry()
    set_global_registry(reg)
    tpols, docs = _smoke_inputs()
    ev1, packed, layout = _evaluator_and_batch(tpols, docs)
    want = _out(ev1, packed, layout)
    aot.flush_stores()
    ev2, packed2, layout2 = _evaluator_and_batch(tpols, docs)
    key = ev1.plan_for(layout).aot_key
    real = kernels.status_vm

    def broken(packed, program):
        raise RuntimeError('launch failed')
    monkeypatch.setattr(kernels, 'status_vm', broken)
    with pytest.raises(RuntimeError, match='launch failed'):
        ev2(packed2, layout2)
    assert aot.default_store().load(key) is None
    assert not ev2.plans
    assert reg.counter_value(REJECTED, reason='execute_failed') == 1
    monkeypatch.setattr(kernels, 'status_vm', real)
    assert _out(ev2, packed2, layout2) == want
    assert ev2.plan_for(layout2).source == 'fresh_compile'


@pytest.mark.cuda
def test_loaded_program_launches_on_the_card(cuda_card):
    """On the card: K1v with a program loaded from the store equals K1v
    with the program lowered, and the plain version."""
    from kyverno_tpu_torch.compiler import admission
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    tpols, docs = _smoke_inputs()
    cps = compile_policies(tpols)
    outs = []
    for _ in range(2):
        ev = build_evaluator(cps, 'cuda')
        match = np.ones((CAP, ev.n_uniq), np.uint8)
        tensors = _tensors(encode_batch, admission.zero_lanes, cps, ev,
                           docs, CAP, match)
        packed, layout = shard_batch(tensors, 'cuda')
        out = b''.join(a.tobytes() for a in ev(packed, layout).host())
        plan = ev.plan_for(layout)
        outs.append((plan.source, out,
                     kernels.status_vm(packed, plan.program),
                     plan.program.plain(packed)))
        aot.flush_stores()
    assert [o[0] for o in outs] == ['fresh_compile', 'aot_load']
    assert outs[0][1] == outs[1][1]
    for got in (outs[1][2], outs[1][3], outs[0][3]):
        for a, b in zip(outs[0][2], got):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K1v has no interpret mode')


# ---------------------------------------------------------------------------
# acceptance: a second process loads every program

_SECOND_PROC_SCRIPT = r'''
import json, sys
import numpy as np
from kyverno_tpu_torch.api.policy import Policy
from kyverno_tpu_torch.compiler import admission, aot
from kyverno_tpu_torch.compiler.compile import compile_policies
from kyverno_tpu_torch.compiler.encode import encode_batch
from kyverno_tpu_torch.observability import device as devtel
from kyverno_tpu_torch.observability import executables
from kyverno_tpu_torch.observability.metrics import MetricsRegistry
from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch

inp = json.load(open(sys.argv[1]))
reg = devtel.configure(MetricsRegistry())
executables.configure(registry=reg, ledger_n=16)
cps = compile_policies([Policy(d) for d in inp['policies']])
ev = build_evaluator(cps, 'cpu')
tensors = dict(encode_batch(inp['docs'], cps, padded_n=inp['cap']).tensors())
tensors['__match__'] = np.array(inp['match'], np.uint8)
if ev.adm_table is not None:
    tensors.update(admission.zero_lanes(ev.adm_table, inp['cap']))
packed, layout = shard_batch(tensors, 'cpu')
out8, out32 = ev(packed, layout)
aot.flush_stores()
C = 'kyverno_tpu_compile_cache_requests_total'
print(json.dumps({
    'by_source': executables.census().get('by_source', {}),
    'aot_store': reg.counter_value(C, result='aot_store'),
    'aot_load': reg.counter_value(C, result='aot_load'),
    'out8': out8.numpy().tobytes().hex(),
    'out32': out32.numpy().tobytes().hex()}))
'''


def _run_fresh_process(tmp_path, inputs, aot_enabled=True):
    env = dict(os.environ, PYTHONPATH=REPO,
               KTPU_AOT='1' if aot_enabled else '0',
               KTPU_AOT_CACHE_DIR=str(tmp_path / 'shared-aot'))
    out = subprocess.run([sys.executable, '-c', _SECOND_PROC_SCRIPT,
                          str(inputs)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_second_process_zero_fresh_lowerings(tmp_path, jax_reference):  # noqa: F811
    """Process 1 lowers and stores; process 2 (fresh interpreter, same
    policy set) loads every K1v program and lowers none; process 3 runs
    with the store off.  out8 and out32 are byte-equal across the three
    and to the JAX evaluator on the same inputs."""
    from kyverno_tpu.compiler import admission as jadm
    from kyverno_tpu.compiler.compile import compile_policies as jcomp
    from kyverno_tpu.compiler.encode import encode_batch as jencode
    from kyverno_tpu.ops.eval import build_evaluator as jbuild
    jpols, tpols = load_pack('smoke')
    docs = make_resources('smoke', N_DOCS)
    jc = jcomp(jpols)
    jev = jbuild(jc)
    match = (np.random.default_rng(5).random((CAP, jev.n_uniq)) < 0.85
             ).astype(np.uint8)
    j8, j32 = _run_jax(jev, _tensors(jencode, jadm.zero_lanes, jc, jev,
                                     docs, CAP, match))
    inputs = tmp_path / 'inputs.json'
    inputs.write_text(json.dumps({'policies': [p.raw for p in tpols],
                                  'docs': docs, 'cap': CAP,
                                  'match': match.tolist()}))
    first = _run_fresh_process(tmp_path, inputs)
    assert first['by_source'].get('fresh_compile', 0) >= 1, first
    assert first['aot_store'] >= 1, first
    second = _run_fresh_process(tmp_path, inputs)
    assert second['by_source'].get('fresh_compile', 0) == 0, second
    assert second['by_source'].get('aot_load', 0) >= 1, second
    assert second['aot_load'] >= 1, second
    uncached = _run_fresh_process(tmp_path, inputs, aot_enabled=False)
    assert uncached['by_source'].get('fresh_compile', 0) >= 1, uncached
    assert uncached['aot_store'] == 0, uncached
    for field, want in (('out8', j8), ('out32', j32)):
        assert first[field] == second[field] == uncached[field] == \
            want.tobytes().hex(), field
