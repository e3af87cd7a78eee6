"""The ``inception_v3`` configuration: its walk against the paper's shapes and
its stated work, and the two counter readers of its cell against the counts
the walk's shapes give, on a tiny run on the CPU."""

import json
import math

import pytest
import torch

from benchmark import count_reads, harness, span_reads, yardstick
from benchmark.reference import inception_v3 as walk
from benchmark.reference import recipes
from benchmark.reference.layers import FloatOps, ShapeOps

from .conftest import spec, tiny

CELL = 'inception_v3.w8a8_serving.b128'
CONFIG = json.loads((harness.HERE / 'configs' / 'inception_v3.json').read_text())
# (channels, grid) of each mixed block's output at 299x299 (Table 1, torchvision)
BLOCKS = {'Mixed_5b': (256, 35), 'Mixed_5c': (288, 35), 'Mixed_5d': (288, 35),
          'Mixed_6a': (768, 17), 'Mixed_6b': (768, 17), 'Mixed_6c': (768, 17),
          'Mixed_6d': (768, 17), 'Mixed_6e': (768, 17), 'Mixed_7a': (1280, 8),
          'Mixed_7b': (2048, 8), 'Mixed_7c': (2048, 8)}


def test_block_outputs_have_the_papers_shapes():
    out = {}
    x = torch.empty((1, 3, 299, 299), device='meta')
    logits = walk.forward(recipes.meta_params('inception_v3'), x, FloatOps(), blocks_out=out)
    assert {k: (v.shape[1], v.shape[2]) for k, v in out.items()} == BLOCKS
    assert all(v.shape[2] == v.shape[3] for v in out.values())
    assert tuple(logits.shape) == (1, 1000)


def test_work_is_the_configurations():
    """94 convs and the classifier at 299x299; the multiply-accumulates the
    configuration states, the paper's 5.7 G."""
    ops = recipes._shapes('inception_v3', 299)
    assert sum(len(w) == 4 for _, _, w, _, _ in ops.layers) == 94
    macs = yardstick.work('inception_v3', CONFIG['input_size'], 1)['ops'] // 2
    assert macs == CONFIG['macs_per_image'] and macs / 1e9 == pytest.approx(5.7, rel=0.01)


def _cat_bytes(size: int, batch: int) -> int:
    """float32 bytes the walk's concatenations write, counted as it runs on
    the ``meta`` device."""
    seen = []

    class Cats(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            y = func(*args, **(kwargs or {}))
            if func is torch.cat:
                seen.append(y.numel() * 4)
            return y

    x = torch.empty((batch, 3, size, size), device='meta')
    with Cats():
        walk.forward(recipes.meta_params('inception_v3'), x, ShapeOps())
    assert len(seen) == 15
    return sum(seen)


def test_counter_readers_read_the_programs_counts():
    """A traced run on the CPU reports what the walk's shapes give: the
    float32 input of every conv but the float stem's and of the classifier,
    and every concatenation's output, a batch."""
    over = tiny(CELL)
    size, batch = over['input_size'], over['batch']
    out = harness.run_cell(CELL, 2 ** 31 + 23, 0.5, True, device='cpu', overrides=over,
                           spec=spec())
    assert out['correct'], out['checks']
    ops = recipes._shapes('inception_v3', size, batch)
    float_in = sum(4 * math.prod(x) for _, x, _, _, in_ch in ops.layers if in_ch != 3)
    assert out['metrics']['float_in_mb.serving']['value'] == pytest.approx(float_in / 1e6)
    assert out['metrics']['concat_mb.serving']['value'] == \
        pytest.approx(_cat_bytes(size, batch) / 1e6)


def test_program_without_the_counters_reads_none(monkeypatch):
    """A program whose forwards carry none of the keys (one older than the
    counters) gives no number; one whose forward lacks a key reads it as 0."""
    from cnn_quantization_tpu_torch.utils.spans import SpanRecord
    t0 = 1_000_000_000
    rec = {'traffic': {'path': 'serving', 'loop': 'sweep'},
           'window': {'stamps': [t0 / 1e9], 'seconds': 1.0}}
    counts = [{'int8_gemm.wgmma': 3}, {'int8_gemm.wgmma': 3}]
    snap = {'held_from_ns': 0, 'spans': [
        SpanRecord(i, 'engine.forward', t0 + i, t0 + i + 1, None, i, c)
        for i, c in enumerate(counts)]}
    monkeypatch.setattr(span_reads, 'snapshot', lambda: snap)
    for name in ('float_in_mb.serving', 'concat_mb.serving'):
        assert harness.reader(name).read(rec) is None
    counts[1]['concat.bytes'] = 3_000_000
    assert count_reads.forward_mb(rec, ('concat.bytes',)) == pytest.approx(1.5)
    assert harness.reader('concat_mb.serving').read(dict(rec, traffic={
        'path': 'sim', 'loop': 'sweep'})) is None
