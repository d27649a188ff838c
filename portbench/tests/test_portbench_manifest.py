"""``BENCHMARK.json`` keeps to the benchmark's contract, and each name in
it is found as a file."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _e2e_of(bench, cell):
    return {m['name'] for m in bench['end_to_end']
            if 'workloads' not in m or cell in m['workloads']}


def test_keys_names_and_units(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= bench['run_seconds'] <= 51
    names = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    names += [c['name'] for c in bench['configs']]
    names += [w['name'] for w in bench['workloads']]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'layer', 'moves', 'workloads'}
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' and 'workloads' not in m
               for m in bench['end_to_end'])
    for m in bench['per_layer']:
        if m['name'].split('.')[0].endswith('_roofline'):
            assert m['unit'] == '%'


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w['name'] for w in bench['workloads']}
    for w in bench['workloads']:
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
        e2e = _e2e_of(bench, w['name'])
        assert 'setup_s' in e2e and len(e2e) >= 2
        layer = [m for m in bench['per_layer']
                 if w['name'] in m.get('workloads', [])]
        assert layer, w['name']
    for m in bench['per_layer']:
        assert set(m['workloads']) <= cells
        for cell in m['workloads']:
            assert m['moves'] in _e2e_of(bench, cell), (m['name'], cell)


def test_each_name_is_a_file(bench):
    assert bench['paths'] == ['portbench']
    assert bench['command'] == ['python3', 'portbench/run.py']
    for c in bench['configs']:
        assert c['file'] == f"portbench/configs/{c['name']}.json"
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        for text in (c['source'], c['why']):
            assert 1 <= len(text) <= 200 and '\n' not in text
        with open(os.path.join(ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['reduced'] == c['reduced']
        assert cfg['source'] == c['source']
        for pack in cfg['packs']:
            assert os.path.exists(os.path.join(
                ROOT, 'portbench', 'packs', pack + '.yaml'))
            assert os.path.exists(os.path.join(
                ROOT, 'portbench', 'refs', pack + '.py'))
    for w in bench['workloads']:
        with open(os.path.join(ROOT, 'portbench', 'traffic',
                               w['traffic'] + '.json')) as f:
            driver = json.load(f)['driver']
        assert os.path.exists(os.path.join(ROOT, 'portbench', 'drivers',
                                           driver + '.py'))
    for m in bench['per_layer']:
        assert os.path.exists(os.path.join(
            ROOT, 'portbench', 'metrics', m['name'] + '.py')), m['name']


def test_nothing_reads_the_jax_bench_or_the_smoke_script():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, 'portbench')):
        if 'tests' in dirpath.split(os.sep):
            continue
        for name in files:
            if not name.endswith('.py'):
                continue
            with open(os.path.join(dirpath, name)) as f:
                text = f.read()
            for word in ('bench.py', 'chip_smoke', 'import jax',
                         'kyverno_tpu.', 'from kyverno_tpu import'):
                assert word not in text, (name, word)
