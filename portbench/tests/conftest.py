"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory, beside the program, with traffic cut to a size the
CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the sizes a CPU rehearsal runs at
SMALL = {'bgscan': {'pods': 1200, 'warm_chunks': 2, 'lane_sample': 32}}
SMALL_ENV = {'KTPU_SCAN_CHUNK': '128', 'KTPU_REPORT_FLUSH_ROWS': '64',
             'KTPU_ENCODE_PROCS': '0', 'KTPU_AOT': '0'}

#: a ``sitecustomize`` that refuses to import the JAX stack or the JAX
#: package (top-level names compared whole), and plants the fault that
#: ``PORTBENCH_FAULT`` names under the timed path: a Pod's row altered
#: where it is produced (``altered``), every other Pod left out
#: (``half``), or the control, the plain reference in float32, in the
#: program's place (``float32``)
SITE = r'''
import importlib.abc, os, sys
BLOCKED = {'jax', 'jaxlib', 'flax', 'kyverno_tpu'}
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked in this test')
        return None
sys.meta_path.insert(0, _Block())
fault = os.environ.get('PORTBENCH_FAULT')
if fault:
    sys.path.insert(0, os.environ['PORTBENCH_ROOT'])
    from kyverno_tpu_torch.compiler import scan as _scan
    real_scan = _scan.BatchScanner.scan_report_results
    def scan_report_results(self, resources, now=None):
        if fault == 'float32':
            from portbench import reference
            rules = reference.pack_rules(os.environ['PORTBENCH_PACKS']
                                         .split(','))
        for k, (results, summary, pols) in enumerate(
                real_scan(self, resources, now)):
            if fault == 'altered' and k % 97 == 5 and results:
                results = [dict(results[0], message='altered')] + \
                    list(results[1:])
            if fault == 'half' and k % 2:
                continue
            if fault == 'float32':
                results, summary = reference.report_rows(
                    rules, resources[k], now, 'float32')
            yield results, summary, pols
    _scan.BatchScanner.scan_report_results = scan_report_results
'''


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout of the benchmark in ``tmp_path``: ``BENCHMARK.json``,
    ``portbench/`` with small traffic, and the program beside them."""
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('.build', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    os.symlink(os.path.join(ROOT, 'kyverno_tpu_torch'),
               tmp_path / 'kyverno_tpu_torch')
    for mix, sizes in SMALL.items():
        path = tmp_path / 'portbench' / 'traffic' / f'{mix}.json'
        data = json.loads(path.read_text())
        data.update(sizes)
        path.write_text(json.dumps(data))
    site = tmp_path / 'site'
    site.mkdir()
    (site / 'sitecustomize.py').write_text(SITE)
    return tmp_path


def run_cell(root, workload: str, seed: int, trace: int = 0,
             seconds: float = 8, fault: str = '') -> tuple:
    """``(exit code, last stdout line as JSON or None, stderr)`` of one
    CPU run of ``workload`` in the copy ``root``."""
    env = dict(os.environ, **SMALL_ENV, PYTHONPATH=str(root / 'site'),
               PORTBENCH_ROOT=str(root), PORTBENCH_FAULT=fault,
               PORTBENCH_PACKS='best_practice,jmespath,pss',
               HOME=str(root), TMPDIR=str(root))
    env.pop('JAX_PLATFORMS', None)
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', workload,
         '--seed', str(seed), '--seconds', str(seconds), '--trace',
         str(trace), '--device', 'cpu'],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            pass
    return proc.returncode, result, proc.stderr
