"""What a run's process loads and how it ends without what it needs."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import CELLS, LOADED, ONLINE, ROOT, SWEEPS, tiny

PROBE = """
import json, sys, torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests.conftest import spec
out = harness.run_cell({cell!r}, 5, 0.3, False, device='cpu', overrides={tiny!r}, spec=spec())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


# a sweep and the closed loop
@pytest.mark.parametrize('cell', [SWEEPS[0], ONLINE])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    """Top-level module names compared whole: the port's own name begins
    with the JAX package's."""
    proc = subprocess.run([sys.executable, '-c', PROBE.format(cell=cell, tiny=tiny(cell))],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert 'cnn_quantization_tpu_torch' in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole_words(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cnn_quantization_tpu_torch_extra', sys)
    assert 'cnn_quantization_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert 'jax' in harness.forbidden_modules()


def _run_cli(cwd):
    return subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload',
                           CELLS[0], '--seed', '1', '--seconds', '1',
                           '--trace', '0'], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result(card_absent):
    proc = _run_cli(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ''


def test_without_the_program_no_result(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ''


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    cell = next(c for c in SWEEPS if LOADED[c]['traffic']['path'] == 'serving')
    proc = subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload',
                           cell, '--seed', '3', '--seconds', '2',
                           '--trace', '1'], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['device']['platform'] == 'gpu'
    assert 0 < out['device']['busy_s'] <= out['device']['window_s']
