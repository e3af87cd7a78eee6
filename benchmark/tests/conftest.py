"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repository's root.  They run on the CPU at a tiny size; those marked
``cuda`` need the card and skip without one.

The cells come from ``BENCHMARK.json``, so a new cell is tested by its
entries and files alone.  A configuration may name the square input its
cells run at on the CPU (``cpu_input_size``; 64 where absent): a network
whose strides leave a late block no input at 64 names a larger one."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# a size the CPU holds: 64x64 images, batches of 2
TINY = {'input_size': 64, 'batch': 2, 'pool': 2, 'calibration_images': 4,
        'calibration_batch': 2, 'warmup': 1}


def spec():
    """``BENCHMARK.json``."""
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


# {cell: its configuration, traffic mix and limits}, in BENCHMARK.json's order
LOADED = {w['name']: harness.load_cell(w['name']) for w in spec()['workloads']}
CELLS = tuple(LOADED)
SWEEPS = tuple(c for c in CELLS if LOADED[c]['traffic']['loop'] == 'sweep')
ONLINE = next(c for c in CELLS if LOADED[c]['traffic']['loop'] == 'closed')


def tiny(cell: str, **more) -> dict:
    """``TINY`` at ``cell``'s CPU size, with ``more`` on top."""
    size = LOADED[cell]['config'].get('cpu_input_size', TINY['input_size'])
    return dict(TINY, input_size=size, **more)


@pytest.fixture(autouse=True)
def _few_threads():
    # int32 grouped convs on the CPU stall under many threads
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
