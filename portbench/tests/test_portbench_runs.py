"""Whole runs of each cell on the CPU at small sizes, in a copy of the
benchmark, with the JAX stack and the JAX package blocked from import:
the result line, the comparison, its control in the program's place, a
broken timed path, and a cell added from files alone."""

import json

import pytest

from conftest import run_cell
from portbench import control

CELLS = ['smoke12.bgscan']


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_runs_correct_without_jax(bench_copy, cell, trace):
    rc, result, err = run_cell(bench_copy, cell, 2**31 + 17, trace)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True, err[-3000:]
    assert result['attempted'] > 0 and result['failed'] == 0
    assert list(result)[-1] == 'checks'
    bench = json.loads((bench_copy / 'BENCHMARK.json').read_text())
    if trace == 0:
        want = {m['name'] for m in bench['end_to_end']
                if 'workloads' not in m or cell in m['workloads']}
        assert set(result['metrics']) == want
    else:
        names = {m['name'] for m in bench['per_layer']}
        assert set(result['metrics']) <= names
    assert 'jax' not in err and 'blocked' not in err


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', ['altered', 'half', 'float32'])
def test_a_broken_timed_path_is_not_correct(bench_copy, cell, fault):
    """A row altered where it is produced, half the Pods left out, or
    the control (the reference in float32) in the program's place."""
    rc, result, err = run_cell(bench_copy, cell, 2**31 + 19, fault=fault)
    assert rc == 0, err[-3000:]
    assert result['correct'] is False
    assert result['checks']['rows_wrong']['value'] > 0 or \
        result['checks']['short_passes']['value'] > 0


def test_the_control_fails_and_the_reference_passes(bench_copy):
    cfg, traffic = control.load_parts('smoke12', 'bgscan', str(bench_copy))
    for seed in (1, 2, 3):
        low = control.scan_wrong(cfg, traffic, seed, 'float32')
        same = control.scan_wrong(cfg, traffic, seed, 'float64')
        assert low['compared'] == same['compared'] == traffic['pods']
        assert low['wrong'] > 0 and same['wrong'] == 0


def _add_cell(root, cell: dict, e2e: dict, per_layer: list):
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'].append(cell)
    known = {c['name'] for c in bench['configs']}
    if cell['config'] not in known:
        bench['configs'].append({
            'name': cell['config'], 'source': 'a test',
            'file': f"portbench/configs/{cell['config']}.json",
            'reduced': [], 'why': 'a test'})
    names = {m['name'] for m in bench['end_to_end']}
    if e2e['name'] in names:
        for m in bench['end_to_end']:
            if m['name'] == e2e['name']:
                m['workloads'].append(cell['name'])
    else:
        bench['end_to_end'].append(e2e)
    bench['per_layer'] += per_layer
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))


def test_a_cell_added_from_files_alone_is_found(bench_copy):
    """A scan cell of its own configuration, traffic file and per-layer
    reader."""
    traffic = json.loads(
        (bench_copy / 'portbench/traffic/bgscan.json').read_text())
    traffic['pods'] = 900
    (bench_copy / 'portbench/traffic/bgscan-small.json').write_text(
        json.dumps(traffic))
    (bench_copy / 'portbench/metrics/flushes.scan-small.py').write_text(
        'def read(obs):\n    return float(len(obs["flushes"]))\n')
    cfg = json.loads(
        (bench_copy / 'portbench/configs/smoke12.json').read_text())
    cfg['packs'].remove('pss')
    (bench_copy / 'portbench/configs/smoke12-nopss.json').write_text(
        json.dumps(cfg))
    _add_cell(bench_copy,
              {'name': 'smoke12-nopss.bgscan-small',
               'config': 'smoke12-nopss', 'traffic': 'bgscan-small',
               'chips': 1, 'why': 'a test cell'},
              {'name': 'scan_pods_per_s'},
              [{'name': 'flushes.scan-small', 'unit': 'flushes',
                'better': 'higher', 'source': 'program_counter',
                'layer': 'assembly', 'moves': 'scan_pods_per_s',
                'workloads': ['smoke12-nopss.bgscan-small']}])
    rc, result, err = run_cell(bench_copy, 'smoke12-nopss.bgscan-small',
                               2**31 + 23, trace=1)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True
    assert result['metrics']['flushes.scan-small']['value'] >= 2


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    import os
    import shutil
    import subprocess
    import sys
    from conftest import ROOT
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('.build', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path),
               PYTHONPATH='')
    for device in ('cuda', 'cpu'):
        proc = subprocess.run(
            [sys.executable, 'portbench/run.py', '--workload',
             'smoke12.bgscan', '--seed', '1', '--seconds', '1', '--trace',
             '0', '--device', device],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode != 0
        assert '"correct"' not in proc.stdout
