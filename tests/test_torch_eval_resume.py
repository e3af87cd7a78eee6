"""Eval-loop checkpoint/resume: the port's ``evaluate(resume_path=,
checkpoint_every=)`` against the JAX package's, ResNet-18 at 64x64, W8A8
simulation, the same BN-folded weights in both, batches of 2.

  * interrupted and resumed, the port equals its uninterrupted run: top-1
    and top-5 exactly (the checkpoint's percent averages restore integer
    counts by rounding), the loss within 1e-6 relative; the file is removed
    at the end (the port's counterpart of tests/test_engine.py:173-213);
  * the file is shared: the port resumes from a file the JAX ``evaluate``
    wrote, and JAX from the port's.  Each result equals the restored meters
    combined with the resuming package's own counts over the remaining
    batches (each package's arithmetic): top-1/top-5 exactly, the loss
    within 1e-6 relative;
  * without ``resume_path`` nothing is written, and the loop reads no value
    back from the device; with it, the loop reads the four device sums once
    a checkpoint.

The labels sit at varied ranks of the port's own predictions, so the top-k
counts are neither all misses nor all hits.  The JAX ``evaluate`` jits a new
step each call; the tests hand it one step compiled once.
"""

import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.engine import QuantEngine as JEngine
from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
from cnn_quantization_tpu.engine import evaluate as j_evaluate
from cnn_quantization_tpu.utils.meters import AverageMeter as JAverageMeter

import chip_smoke
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.engine.evaluate import evaluate, make_eval_step

from _torch_parity import Pair

SIZE, BATCH, N_BATCHES = 64, 2, 5
POLICY = dict(arch='resnet18', qtype='int8', qweight='int8')


class Setup:
    def __init__(self):
        pair = Pair('resnet18', SIZE)
        self.eng = QuantEngine(pair.model, QuantPolicy(**POLICY), pair.meta)
        self.pq = self.eng.quantize_params(pair.params)
        self.j_eng = JEngine(pair.j_model, JPolicy(**POLICY), pair.j_meta)
        self.j_pq = self.j_eng.quantize_params(pair.j_params)
        rng = np.random.RandomState(0)
        fwd = self.eng.make_forward()
        self.batches = []
        for b in range(N_BATCHES):
            x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32) * 2 - 1
            order = torch.argsort(-fwd(self.pq, None, x)[0], dim=-1, stable=True)
            ranks = [(3 * b + 5 * r) % 8 for r in range(BATCH)]
            self.batches.append((x, np.array([int(order[r, k]) for r, k in enumerate(ranks)],
                                             np.int32)))


@pytest.fixture(scope='module')
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    s = Setup()
    s.j_step = j_evaluate.make_eval_step(s.j_eng)
    with mock.patch.object(j_evaluate, 'make_eval_step', lambda *a, **k: s.j_step):
        yield s
    torch.set_num_threads(n)


def preempted(batches, fail_at):
    for i, b in enumerate(batches):
        if i == fail_at:
            raise RuntimeError('simulated preemption')
        yield b


def assert_same(got, want):
    assert got['top1'] == want['top1'] and got['top5'] == want['top5'], (got, want)
    assert abs(got['loss'] - want['loss']) <= 1e-6 * abs(want['loss']), (got, want)


@pytest.mark.parametrize('every,fail_at', [(1, 2), (2, 3)])
def test_evaluate_resume(setup, tmp_path, every, fail_at):
    full = evaluate(setup.eng, setup.pq, setup.batches)
    assert 0 < full['top1'] < full['top5'] < 100
    ckpt = str(tmp_path / 'eval_resume.json')
    with pytest.raises(RuntimeError, match='preemption'):
        evaluate(setup.eng, setup.pq, preempted(setup.batches, fail_at), resume_path=ckpt,
                 checkpoint_every=every)
    with open(ckpt) as f:
        assert json.load(f)['batches'] == fail_at // every * every
    resumed = evaluate(setup.eng, setup.pq, setup.batches, resume_path=ckpt,
                       checkpoint_every=every)
    assert not os.path.exists(ckpt) and not os.path.exists(ckpt + '.tmp')
    assert_same(resumed, full)
    assert resumed['images_per_sec'] > 0


def port_combined(ck, eng, params, rest):
    """The port's result from the restored file and its own counts over
    ``rest``, in ``evaluate``'s arithmetic."""
    step = make_eval_step(eng)
    seen = ck['seen']
    top1, top5 = round(ck['top1'] * seen / 100.0), round(ck['top5'] * seen / 100.0)
    loss = torch.tensor(ck['loss'] * seen, dtype=torch.float64)
    for x, y in rest:
        out = step(params, None, x, y)
        top1, top5, loss = top1 + int(out['top1']), top5 + int(out['top5']), loss + out['loss']
        seen += len(y)
    return {'top1': 100.0 * top1 / seen, 'top5': 100.0 * top5 / seen, 'loss': float(loss) / seen}


def jax_combined(ck, step, params, rest):
    """The JAX package's result from the restored file and its own counts
    over ``rest``, in its ``evaluate``'s arithmetic (``AverageMeter``)."""
    meters = {}
    for key in ('top1', 'top5', 'loss'):
        meters[key] = JAverageMeter()
        meters[key].sum, meters[key].count = ck[key] * ck['seen'], ck['seen']
    for x, y in rest:
        out = jax.device_get(step(params, None, x, y))
        n = len(y)
        meters['top1'].update(out['top1'] / n * 100.0, n)
        meters['top5'].update(out['top5'] / n * 100.0, n)
        meters['loss'].update(out['loss'] / n, n)
    return {k: m.avg for k, m in meters.items()}


def test_port_resumes_a_jax_file(setup, tmp_path):
    ckpt = str(tmp_path / 'from_jax.json')
    with pytest.raises(RuntimeError, match='preemption'):
        j_evaluate.evaluate(setup.j_eng, setup.j_pq, preempted(setup.batches, 3),
                            resume_path=ckpt, checkpoint_every=2)
    with open(ckpt) as f:
        ck = json.load(f)
    assert ck['batches'] == 2 and ck['seen'] == 2 * BATCH
    resumed = evaluate(setup.eng, setup.pq, setup.batches, resume_path=ckpt)
    assert not os.path.exists(ckpt)
    assert_same(resumed, port_combined(ck, setup.eng, setup.pq, setup.batches[2:]))


def test_jax_resumes_a_port_file(setup, tmp_path):
    ckpt = str(tmp_path / 'from_port.json')
    with pytest.raises(RuntimeError, match='preemption'):
        evaluate(setup.eng, setup.pq, preempted(setup.batches, 3), resume_path=ckpt,
                 checkpoint_every=2)
    with open(ckpt) as f:
        ck = json.load(f)
    assert set(ck) == {'batches', 'seen', 'top1', 'top5', 'loss', 'ent_sum', 'ent_weight'}
    resumed = j_evaluate.evaluate(setup.j_eng, setup.j_pq, setup.batches, resume_path=ckpt)
    assert not os.path.exists(ckpt)
    assert_same(resumed, jax_combined(ck, setup.j_step, setup.j_pq, setup.batches[2:]))


def test_without_resume_path_nothing_is_written_or_read_back(setup, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = chip_smoke.HostReads()
    loader, marks = chip_smoke.preemptible(setup.batches, reads)
    with reads:
        evaluate(setup.eng, setup.pq, loader)
    assert marks[-1] - marks[0] == 0 and reads.reads == 3   # top-1, top-5, loss at the end
    assert os.listdir(tmp_path) == []
    reads = chip_smoke.HostReads()
    loader, marks = chip_smoke.preemptible(setup.batches, reads)
    with reads:
        evaluate(setup.eng, setup.pq, loader, resume_path='ckpt.json', checkpoint_every=1)
    assert marks[-1] - marks[0] == 4 * N_BATCHES and os.listdir(tmp_path) == []
