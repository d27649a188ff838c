"""The port stands alone: ``kyverno_tpu_torch`` (and ``chip_smoke.py``)
import neither jax nor any module of the JAX package ``kyverno_tpu`` —
the name check matches ``kyverno_tpu`` and ``kyverno_tpu.*`` exactly,
since ``kyverno_tpu_torch`` shares the prefix.  The host modules it
carries are verbatim copies of the JAX package's, and its entry points
default to the CUDA card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'kyverno_tpu_torch')
REF = os.path.join(ROOT, 'kyverno_tpu')

#: modules of the port whose device seams differ from the JAX package's
PORTED = {'__init__.py', 'ops/eval.py', 'compiler/scan.py'}
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
    files.append(os.path.join(ROOT, 'chip_smoke.py'))
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


def test_port_imports_and_scans_with_jax_blocked():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _CHILD, ROOT],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ISOLATED-OK' in proc.stdout


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
    own = {'device.py', 'smokepack.py', 'ops/kernels.py', 'ops/_build.py'}
    extra = [rel for rel, _p in _port_sources()
             if not os.path.exists(os.path.join(REF, rel)) and rel not in own]
    assert extra == []


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
