"""The port stands alone: ``kyverno_tpu_torch`` (and ``chip_smoke.py``)
import neither jax nor any module of the JAX package ``kyverno_tpu`` —
the name check matches ``kyverno_tpu`` and ``kyverno_tpu.*`` exactly,
since ``kyverno_tpu_torch`` shares the prefix.  The host modules it
carries are verbatim copies of the JAX package's, and its entry points
default to the CUDA card."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'kyverno_tpu_torch')
REF = os.path.join(ROOT, 'kyverno_tpu')

#: modules of the port whose device seams differ from the JAX package's
PORTED = {'__init__.py', 'ops/eval.py', 'compiler/scan.py',
          'observability/device.py', 'observability/catalog.py',
          'mutate/kernel.py', 'mutate/scanner.py', 'partition/keys.py',
          'partition/runtime.py', 'verdictcache/keys.py',
          'webhooks/handlers.py', 'parallel/mesh.py',
          'observability/fleet.py', 'observability/profiling.py',
          'observability/executables.py', 'reports/controllers.py',
          'cmd/reports_controller.py', 'controllers/leaderelection.py',
          'aotcache/keys.py', 'compiler/aot.py',
          'cmd/admission_controller.py', 'reports/types.py',
          'dclient/http_client.py', 'conformance/kuttl.py',
          'analysis/__init__.py', 'analysis/core.py',
          'analysis/jitgraph.py', 'analysis/trace_safety.py',
          'analysis/retrace.py', 'analysis/taxonomy.py',
          'analysis/envreg.py', 'analysis/knobs.py',
          'analysis/catalog_pass.py', 'analysis/concurrency.py'}
#: verbatim copies whose absolute self-import was renamed, by line
REWRITTEN = {'engine/jmespath/__init__.py': {5}}


def _blocked(name: str) -> bool:
    return (name in ('jax', 'jaxlib', 'kyverno_tpu')
            or name.startswith(('jax.', 'jaxlib.', 'kyverno_tpu.')))


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith('.py'):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, PORT), path


def _imports(path):
    tree = ast.parse(open(path, encoding='utf-8').read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_blocker_matches_exact_names():
    assert _blocked('kyverno_tpu') and _blocked('kyverno_tpu.ops.eval')
    assert not _blocked('kyverno_tpu_torch')
    assert not _blocked('kyverno_tpu_torch.ops.eval')
    assert _blocked('jax.numpy') and not _blocked('jaxtyping')


def test_no_source_imports_jax_or_the_jax_package():
    files = [p for _rel, p in _port_sources()]
    files += [os.path.join(ROOT, 'chip_smoke.py'),
              os.path.join(ROOT, 'k1v_bench.py')]
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imports(p) if _blocked(m)]
    assert bad == []


_CHILD = r'''
import importlib, importlib.abc, os, sys, random

def blocked(name):
    return (name in ('jax', 'jaxlib', 'kyverno_tpu')
            or name.startswith(('jax.', 'jaxlib.', 'kyverno_tpu.')))

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError('blocked import: ' + name)
        return None

sys.meta_path.insert(0, Blocker())
root = sys.argv[1]
sys.path.insert(0, root)
pkg = os.path.join(root, 'kyverno_tpu_torch')
for dirpath, _d, files in os.walk(pkg):
    for f in files:
        if f.endswith('.py'):
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            mod = rel.replace(os.sep, '.')
            if mod.endswith('.__init__'):
                mod = mod[:-9]
            importlib.import_module(mod)
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.compiler.scan import BatchScanner
policies = smokepack.load_smoke_pack()
rng = random.Random(0)
pods = [smokepack.make_config4_pod(rng, i) for i in range(6)]
rows = list(BatchScanner(policies, device='cpu').scan_report_results(
    pods, now=1))
assert len(rows) == 6
for pod, (results, summary, _p) in zip(pods, rows):
    assert (results, summary) == smokepack.host_report_results(
        policies, pod, 1)
assert not [m for m in sys.modules if blocked(m)]
print('ISOLATED-OK')
'''

_CHILD_WEBHOOK = _CHILD.split('from kyverno_tpu_torch import smokepack')[0] + r'''
import json, time
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.observability import provenance
from kyverno_tpu_torch.policycache import cache as pcache
from kyverno_tpu_torch.policycache.cache import Cache
from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
from kyverno_tpu_torch.webhooks.server import WebhookServer
cache = Cache()
cache.warm_up(smokepack.load_smoke_pack('Enforce') +
              smokepack.load_mutate_pack())
handlers = ResourceHandlers(cache, torch_device='cpu')
host = WebhookServer(ResourceHandlers(cache, device=False))
server = WebhookServer(handlers)
assert handlers.wait_device_ready(
    cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod', 'ns-1'), timeout=120)
mutate = cache.get_policies(pcache.MUTATE, 'Pod', 'ns-1')
deadline = time.monotonic() + 120
while handlers._device_scanner(mutate, kind='mutate') is None:
    assert time.monotonic() < deadline
    time.sleep(0.02)
rng = random.Random(1)
reviews = []
for route, pod in (('/validate/fail', smokepack.make_config4_pod(rng, 1)),
                   ('/mutate', smokepack.make_mutate_pod(rng, 1))):
    body = json.dumps({'apiVersion': 'admission.k8s.io/v1',
                       'kind': 'AdmissionReview', 'request': {
        'uid': route, 'operation': 'CREATE',
        'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},
        'namespace': 'ns-1', 'name': 'pod-1', 'object': pod,
        'userInfo': {'username': 'alice', 'groups': []},
        'timeoutSeconds': 10}}).encode()
    reviews.append((route, body, host.handle(route, body)))
rec = provenance.configure(flight_n=16, dump_dir=sys.argv[2])
for route, body, want in reviews:
    assert server.handle(route, body) == want, route
paths = [r.path for r in rec.records()]
assert paths == ['sync'], paths
assert not [m for m in sys.modules if blocked(m)]
print('ISOLATED-OK')
'''


def test_port_imports_and_scans_with_jax_blocked():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _CHILD, ROOT],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ISOLATED-OK' in proc.stdout


def test_port_serves_admission_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _CHILD_WEBHOOK, ROOT,
                           str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ISOLATED-OK' in proc.stdout


_CHILD_MESH = _CHILD.split('from kyverno_tpu_torch import smokepack')[0] + r'''
import runpy
sys.argv = ['chip_smoke.py'] + sys.argv[2:]
try:
    runpy.run_path(os.path.join(root, 'chip_smoke.py'), run_name='__main__')
except SystemExit as e:
    assert not e.code, e.code
assert not [m for m in sys.modules if blocked(m)]
print('ISOLATED-OK')
'''


def test_chip_smoke_mesh_children_run_with_jax_blocked(tmp_path):
    """The two ranks that ``chip_smoke.py`` spawns for its two-rank mesh
    phase, run here on the CPU at a tiny size under gloo with the import
    blocker: they import nothing of JAX and agree."""
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    env.update({'KTPU_SCAN_CHUNK': '16', 'KTPU_ENCODE_PROCS': '0',
                'GLOO_SOCKET_IFNAME': 'lo'})
    args = ['--pods', '49', '--step-rows', '32',
            '--store', str(tmp_path / 'store'), '--device', 'cpu',
            '--mesh-child']
    procs = []
    for rank in range(2):
        # output to files: a rank blocked on a full pipe would stall its
        # peer in a collective
        with open(tmp_path / f'rank{rank}.out', 'w') as out, \
                open(tmp_path / f'rank{rank}.err', 'w') as err:
            procs.append(subprocess.Popen(
                [sys.executable, '-c', _CHILD_MESH, ROOT] + args + [str(rank)],
                cwd=ROOT, env=env, stdout=out, stderr=err))
    results = []
    try:
        for rank, proc in enumerate(procs):
            proc.wait(timeout=240)
            out = (tmp_path / f'rank{rank}.out').read_text()
            err = (tmp_path / f'rank{rank}.err').read_text()
            assert proc.returncode == 0, err[-3000:]
            assert 'ISOLATED-OK' in out
            [line] = [ln for ln in out.splitlines()
                      if ln.startswith('mesh_child ')]
            results.append(json.loads(line[len('mesh_child '):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    r0, r1 = sorted(results, key=lambda r: r['rank'])
    assert (r0['rank'], r0['leader'], r1['rank'], r1['leader']) == \
        (0, True, 1, False)
    assert r1['process_index'] == 1
    for key in ('summary', 'statuses', 'row_digest'):
        assert r0[key] == r1[key], key
    assert r0['pods'] == 49 and r0['step_rows'] == 32


def test_chip_smoke_admission_daemon_runs_with_jax_blocked(tmp_path):
    """One admission-daemon process of ``chip_smoke.py``'s phase 10
    (``cmd/admission_controller.py`` with TLS, its AOT store, the
    generate hand-off and the audit reports), run here on the CPU at a
    tiny size with the import blocker: it imports nothing of JAX and
    its checks pass."""
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    env.update({'KTPU_AOT_CACHE_DIR': str(tmp_path / 'aot'),
                'KTPU_COMPILE_CACHE': str(tmp_path / 'lib')})
    out = tmp_path / 'daemon.json'
    proc = subprocess.run(
        [sys.executable, '-c', _CHILD_MESH, ROOT, '--device', 'cpu',
         '--reviews', '4', '--namespaces', '2', '--admission-child',
         str(out)], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ISOLATED-OK' in proc.stdout
    rec = json.loads(out.read_text())
    assert rec['problems'] == [] and rec['mismatches'] == 0
    assert rec['lowered_by_source'] == {'fresh_compile': 1}
    assert (rec['update_requests'], rec['network_policies'],
            rec['admission_reports']) == (2, 2, 2)


def test_chip_smoke_restart_children_run_with_jax_blocked(tmp_path):
    """The two processes of ``chip_smoke.py``'s phase 11 in turn, run
    here on the CPU at a tiny size with the import blocker, against one
    ``FakeApiServer`` over HTTP: the reports daemon and the admission
    daemon (TLS, its AOT store, the verdict cache) import nothing of JAX;
    the restarted one loads its program, replays every report row and
    stamps the server's current resourceVersions."""
    import chip_smoke
    from kyverno_tpu_torch.dclient.fakeserver import FakeApiServer
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    env.update({'KTPU_AOT_CACHE_DIR': str(tmp_path / 'aot'),
                'KTPU_COMPILE_CACHE': str(tmp_path / 'lib'),
                'KTPU_VERDICT_CACHE_DIR': str(tmp_path / 'vc'),
                'KTPU_PARTITIONS': '0', 'KTPU_ENCODE_PROCS': '0'})
    server = FakeApiServer(chip_smoke.restart_cluster(0, 24))
    chip_smoke.register_kinds(server)
    runs = {}
    with server:
        for name in ('FIRST', 'SECOND'):
            out = tmp_path / f'{name}.json'
            proc = subprocess.run(
                [sys.executable, '-c', _CHILD_MESH, ROOT, '--device', 'cpu',
                 '--reviews', '4', '--namespaces', '2', '--api-server',
                 server.url, '--restart-child', name, str(out)],
                capture_output=True, text=True, timeout=240, cwd=ROOT,
                env=env)
            assert proc.returncode == 0, proc.stderr[-3000:]
            assert 'ISOLATED-OK' in proc.stdout
            runs[name] = json.loads(out.read_text())
            assert runs[name]['problems'] == []
    first, second = runs['FIRST'], runs['SECOND']
    assert first['admission']['lowered_by_source'] == {'fresh_compile': 1}
    assert second['admission']['lowered_by_source'] == {'aot_load': 1}
    assert second['admission']['labels']['stale'] == 0
    assert second['admission']['labels']['reports'] == 2
    st = second['reports']['rescan']
    assert st['rows_replayed'] == st['rows_pending'] > 24
    assert second['reports']['reports'] == 24
    for key in ('generation', 'rows_digest', 'body_digest'):
        assert second['reports'][key] == first['reports'][key], key


def test_engine_rev_digests_the_ports_own_sources():
    """Verdict keys of the port never coincide with the JAX package's:
    ``engine_rev`` reads the port's own evaluator, kernels, compiler,
    scan and report sources."""
    from kyverno_tpu.verdictcache import keys as jax_keys
    from kyverno_tpu_torch.observability import provenance
    from kyverno_tpu_torch.verdictcache import keys
    for rel in keys.ENGINE_SOURCES:
        assert os.path.isfile(os.path.join(PORT, rel)), rel
    # a kernel change is an engine change: every CUDA source and header,
    # the wrappers and K1v's lowering are digested
    cu = {f'csrc/{f}' for f in os.listdir(os.path.join(PORT, 'csrc'))
          if f.endswith(('.cu', '.cuh'))}
    assert {'csrc/k1_vm.cuh', 'csrc/glob_dp.cuh'} <= cu
    assert cu | {'ops/kernels.py', 'ops/vm.py'} <= set(keys.ENGINE_SOURCES)
    rev = keys.engine_rev()
    assert len(rev) == 16 and rev != jax_keys.engine_rev()
    assert provenance._engine_rev() == rev
    assert keys.generation_key('f') == f'f-{rev}'


def test_resolve_device(monkeypatch):
    from kyverno_tpu_torch.device import resolve_device
    assert resolve_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device('cuda')


@pytest.mark.parametrize('rel', sorted(
    rel for rel, _p in _port_sources()
    if rel not in PORTED and os.path.exists(os.path.join(REF, rel))))
def test_verbatim_copies_equal_their_originals(rel):
    port = open(os.path.join(PORT, rel), encoding='utf-8').read()
    ref = open(os.path.join(REF, rel), encoding='utf-8').read()
    renamed = REWRITTEN.get(rel, set())
    p_lines, r_lines = port.split('\n'), ref.split('\n')
    assert len(p_lines) == len(r_lines)
    for i, (a, b) in enumerate(zip(p_lines, r_lines), start=1):
        if i in renamed:
            assert a == b.replace('kyverno_tpu', 'kyverno_tpu_torch'), i
        else:
            assert a == b, (rel, i)


def test_port_has_no_module_missing_from_the_layout():
    """Every module of the port either mirrors a JAX-package module at
    the same relative path or is one of the port's own."""
    own = {'device.py', 'smokepack.py', 'ops/kernels.py', 'ops/_build.py',
           'ops/vm.py', 'analysis/__main__.py'}
    extra = [rel for rel, _p in _port_sources()
             if not os.path.exists(os.path.join(REF, rel)) and rel not in own]
    assert extra == []


def test_every_module_of_the_jax_package_has_its_port():
    """The port does everything the JAX package does: each ``*.py`` of
    ``kyverno_tpu/`` has a counterpart at the same relative path."""
    ref = set()
    for dirpath, _dirs, files in os.walk(REF):
        ref.update(os.path.relpath(os.path.join(dirpath, f), REF)
                   for f in files if f.endswith('.py'))
    port = {rel for rel, _p in _port_sources()}
    assert sorted(ref - port) == []


def test_kuttl_differs_from_its_reference_only_by_the_device_seam():
    """``conformance/kuttl.py`` is the reference's but for the
    ``device`` its cluster hands the admission and reports daemons."""
    import difflib
    port = open(os.path.join(PORT, 'conformance', 'kuttl.py'),
                encoding='utf-8').read().split('\n')
    ref = open(os.path.join(REF, 'conformance', 'kuttl.py'),
               encoding='utf-8').read().split('\n')
    diff = [ln for ln in difflib.unified_diff(ref, port, n=0, lineterm='')
            if ln[:1] in '+-' and not ln.startswith(('+++', '---'))]
    added = [ln[1:] for ln in diff if ln[0] == '+']
    removed = [ln[1:] for ln in diff if ln[0] == '-']
    assert added and all('device' in ln for ln in added), added
    # the code lines, the seam taken out, are the reference's lines
    seamless = [re.sub(r'(, )?device=(None|device)', '', ln) for ln in added
                if '``' not in ln and 'torch device' not in ln]
    docstring = [ln for ln in removed if ln.endswith('steps."""')]
    assert sorted(seamless + docstring) == sorted(removed), diff


def test_vm_lowering_imports_neither_jax_nor_the_jax_package():
    path = os.path.join(PORT, 'ops', 'vm.py')
    mods = list(_imports(path))
    assert mods and not [m for m in mods if _blocked(m)]


def test_library_path_digests_included_headers(tmp_path):
    """An edit to a header a kernel includes, directly or through
    another header, names a new build; an edit to an unrelated header
    does not."""
    import shutil
    from kyverno_tpu_torch.ops import _build
    csrc = tmp_path / 'csrc'
    shutil.copytree(os.path.join(PORT, 'csrc'), csrc)
    assert [os.path.basename(p) for p in _build.sources('k1_vm', str(csrc))] \
        == ['k1_vm.cu', 'k1_vm.cuh', 'glob_dp.cuh']
    before = {n: _build.library_path(n, str(csrc)) for n in _build.KERNELS}
    with open(csrc / 'glob_dp.cuh', 'a') as f:
        f.write('\n// edited\n')
    after = {n: _build.library_path(n, str(csrc)) for n in _build.KERNELS}
    changed = {n for n in _build.KERNELS if before[n] != after[n]}
    assert changed == {'k1_vm', 'k1c_wildcard'}
    with open(csrc / 'k1_vm.cuh', 'a') as f:
        f.write('\n// edited\n')
    again = {n: _build.library_path(n, str(csrc)) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if after[n] != again[n]} == {'k1_vm'}


def test_host_helpers_of_the_evaluator_are_byte_identical():
    """pack_batch / unpack_batch / fold_match_unique / expand_compact
    are host numpy code shared with the JAX evaluator unchanged."""
    def functions(path):
        src = open(path, encoding='utf-8').read()
        return {n.name: ast.get_source_segment(src, n)
                for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef)}
    ref = functions(os.path.join(REF, 'ops', 'eval.py'))
    port = functions(os.path.join(PORT, 'ops', 'eval.py'))
    for name in ('pack_batch', 'unpack_batch', 'fold_match_unique',
                 'expand_compact'):
        assert port[name] == ref[name], name
