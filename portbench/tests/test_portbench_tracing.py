"""The per-layer metrics read from the program's own stages (``wait``,
``match``, ``gc``, the stages' thread CPU seconds, and ``device``, the
K1 calls' CUDA-event time): a traced CPU run gives the four host
metrics and no device metric; on the card (marker ``cuda``) the device
metric is there too, and the new metrics agree with the old ones."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell

HOST = ('match.ms_per_chunk.scan', 'wait.ms_per_chunk.scan',
        'gc.ms_per_chunk.scan', 'assembly.cpu_ms_per_chunk.scan')
DEVICE = 'eval.device_ms_per_chunk.scan'


def test_a_traced_cpu_run_reads_the_host_stages_and_no_device_time(
        bench_copy):
    rc, result, err = run_cell(bench_copy, 'smoke12.bgscan', 2**31 + 29,
                               trace=1)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True
    metrics = result['metrics']
    for name in HOST:
        assert name in metrics, (name, sorted(metrics))
        assert metrics[name]['value'] >= 0 and metrics[name]['unit'] == 'ms'
    assert metrics['match.ms_per_chunk.scan']['value'] > 0
    assert metrics['wait.ms_per_chunk.scan']['value'] > 0
    assert DEVICE not in metrics


def test_the_readers_leave_out_a_program_without_the_stages():
    """A program that records none of the new stages (the parent of
    this benchmark's change) gives no reading, and no error."""
    import importlib.util
    obs = {'chunk': 128,
           'flushes': [(0.0, 0, {'report': 1.0, 'd2h': 0.1}),
                       (2.0, 256, {'report': 3.0, 'd2h': 0.3})]}
    for name in HOST + (DEVICE,):
        path = os.path.join(ROOT, 'portbench', 'metrics', name + '.py')
        spec = importlib.util.spec_from_file_location('m', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert module.read(obs) is None, name
        assert module.read({'chunk': 128, 'flushes': []}) is None


@pytest.fixture
def card():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA CUDA card')


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_device_time(card):
    """The benchmark's own window: a pipeline stage of a window of one
    chunk can read 0, its chunk's work falling past the last flush."""
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'smoke12.bgscan',
         '--seed', '4243', '--seconds', '51', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result['correct'] is True
    m = {k: v['value'] for k, v in result['metrics'].items()}
    for name in HOST + (DEVICE,):
        assert name in m, (name, sorted(m))
    assert m['assembly.cpu_ms_per_chunk.scan'] <= \
        m['assembly.ms_per_chunk.scan']
    gaps = None
    for line in proc.stderr.splitlines():
        if line.startswith('portbench: flush_gaps_s '):
            gaps = json.loads(line[len('portbench: flush_gaps_s '):])
    assert gaps
    interval_ms = 1e3 * sum(gaps) / len(gaps)
    assert m['wait.ms_per_chunk.scan'] + m['assembly.ms_per_chunk.scan'] \
        <= 1.05 * interval_ms
    assert m[DEVICE] > 0
