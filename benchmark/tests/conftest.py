"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repository's root.  They run on the CPU at a tiny size; those marked
``cuda`` need the card and skip without one."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a size the CPU holds: 64x64 images, batches of 2
TINY = {'input_size': 64, 'batch': 2, 'pool': 2, 'calibration_images': 4,
        'calibration_batch': 2, 'warmup': 1}
CELLS = ('resnet50.w4a4_sim.b128', 'resnet50.w8a8_serving.b128',
         'mobilenet_v2.w8a8_serving.b128', 'resnet50.w8a8_serving.b8')
ONLINE = 'resnet50.w8a8_serving.b8'


def spec():
    """``BENCHMARK.json``."""
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


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
