"""Each cell, briefly, on the card (marker ``cuda``; skips without one)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def card():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['smoke12.bgscan'])
def test_cell_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell, '--seed',
         '4242', '--seconds', '15', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '"correct": true' in proc.stdout.splitlines()[-1]
