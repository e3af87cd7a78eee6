"""Whole runs of each cell on the CPU at a tiny size, past the harness's look
for a card: the program's plain path against the reference, the control
against the reference, and the timed path broken underneath."""

import pytest
import torch

from benchmark import harness

from .conftest import CELLS, LOADED, SWEEPS, spec, tiny

SEED = 2 ** 31 + 11


def run(cell, fault=None):
    closed = LOADED[cell]['traffic']['loop'] == 'closed'
    overrides = tiny(cell, pool=3) if closed else tiny(cell)
    return harness.run_cell(cell, SEED, 0.5, False, device='cpu', overrides=overrides,
                            fault=fault, spec=spec())


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out['correct'], out['checks']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    names = {m['name'] for m in harness.cell_metrics(spec(), cell, False)}
    assert set(out['metrics']) == names


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    """The reference in the precision below the configuration's (on the CPU,
    its weights read in bfloat16; TF32 exists only on the card) fails one
    number at least."""
    numbers = harness.control_numbers(cell, SEED, device='cpu', overrides=tiny(cell),
                                      spec=spec())
    ok, checks = harness.judge.verdict(numbers, harness.load_cell(cell, spec())['limits'])
    assert not ok, checks


def stale():
    """Each forward returns the previous forward's answer: a step that leaves
    its state unchanged."""
    prev = []

    def fault(logits):
        out = prev[-1] if prev else logits
        prev.append(logits)
        return out
    return fault


def half_batch(logits):
    """Half of the batch left out: its rows copy the other half's."""
    n = logits.shape[0] // 2
    out = logits.clone()
    out[n:2 * n] = logits[:n]
    return out


def altered(logits):
    """One answer altered where it is produced: the first image's top logit
    moved to the bottom."""
    out = logits.clone()
    out[0, torch.argmax(out[0])] = out[0].min() - 1.0
    return out


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', ['stale', 'half_batch', 'altered'])
def test_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, fault=stale() if fault == 'stale' else globals()[fault])
    assert not out['correct'], out['checks']


@pytest.mark.parametrize('cell', SWEEPS)
@pytest.mark.parametrize('fault', ['misses', 'one_more'])
def test_miscounted_topk_is_not_correct(cell, fault, monkeypatch):
    """``evaluate``'s counts broken, its logits left right: the errors counted
    instead of the hits, or one image more each batch."""
    from cnn_quantization_tpu_torch.engine import evaluate as ev
    counts = ev.accuracy_counts

    def broken(logits, labels, ks=(1, 5)):
        out = counts(logits, labels, ks)
        if fault == 'misses':
            return {k: logits.shape[0] - c for k, c in out.items()}
        return {k: c + 1 for k, c in out.items()}

    monkeypatch.setattr(ev, 'accuracy_counts', broken)
    out = run(cell)
    assert not out['correct'], out['checks']
    assert out['checks']['logits']['value'] == 0 and out['checks']['topk']['value'] > 0
