"""What a walk declares to the reference: the weights it keeps at 8 bits
(``EIGHT_BIT_WEIGHTS``) and its batch norms' ``eps``."""

import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import quant as Q
from benchmark.reference import recipes
from benchmark.reference.layers import FloatOps

from .conftest import spec

SEED = 2 ** 31 + 17
ARCHS = [c['name'] for c in spec()['configs']]


def weights(arch):
    return inputs.make_weights(recipes.model(arch).param_shapes(), SEED, 'cpu')


def grid(w, bits):
    """One weight as the simulation's recipe prepares it at ``bits``: per
    channel, bit allocation below 8 bits, bias-corrected."""
    t = w.contiguous()
    s = Q.channel_stats(t, ['min', 'max'], axis=0)
    if bits <= 4:
        std = Q.channel_stats(t, ['std'], axis=0)['std']
        qmax = Q.qmax_for_bits(Q.bits_alloc_fixed_target(std, bits))
    else:
        qmax = 2.0 ** bits - 1.0
    w_q = Q.fake_quant(t, s['max'] - s['min'], s['min'], qmax, axis=0)
    return Q.bias_correct(w, w_q).to(w.dtype)


@pytest.mark.parametrize('arch', [a for a in ARCHS if not recipes.eight_bit_weights(a)])
def test_sim_weights_without_a_declaration(arch):
    """A walk that declares no 8-bit weights: 8 bits for a three-channel conv
    and every linear, 4 for the rest, bit for bit."""
    P = weights(arch)
    out = recipes.sim_weights(arch, P)
    assert set(out) == set(P)
    for k, w in P.items():
        if k.endswith('.weight') and w.ndim in (2, 4):
            bits = 8 if (w.ndim == 4 and w.shape[1] == 3) or w.ndim == 2 else 4
            assert torch.equal(out[k], grid(w, bits)), k
        else:
            assert out[k] is w, k


def test_sim_weights_keep_the_declared_at_8_bits(monkeypatch):
    """The paths a walk declares, matched as substrings, get 8-bit grids;
    nothing else moves."""
    arch = ARCHS[0]
    P = weights(arch)
    four = [k for k, w in P.items() if k.endswith('.weight') and w.ndim == 4 and w.shape[1] > 3]
    declared = (four[1][:-len('.weight')], four[4][:-len('.weight')])
    before = recipes.sim_weights(arch, P)
    monkeypatch.setattr(recipes.model(arch), 'EIGHT_BIT_WEIGHTS', declared, raising=False)
    after = recipes.sim_weights(arch, P)
    for k in P:
        if k in (four[1], four[4]):
            assert torch.equal(after[k], grid(P[k], 8)), k
            assert not torch.equal(after[k], before[k]), k
        else:
            assert torch.equal(after[k], before[k]), k


@pytest.mark.parametrize('kwargs,eps', [({}, 1e-5), ({'eps': 1e-3}, 1e-3)])
def test_batch_norm_takes_the_walks_eps(kwargs, eps):
    """1e-5 unless the walk passes its own (the variances here are small
    enough that the two differ)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 5, 5, generator=gen)
    P = {'bn.weight': 1 + 0.1 * torch.randn(8, generator=gen),
         'bn.bias': 0.1 * torch.randn(8, generator=gen),
         'bn.running_mean': 0.1 * torch.randn(8, generator=gen),
         'bn.running_var': torch.rand(8, generator=gen) * 1e-2}
    want = F.batch_norm(x, P['bn.running_mean'], P['bn.running_var'], P['bn.weight'],
                        P['bn.bias'], eps=eps)
    torch.testing.assert_close(FloatOps().bn(P, x, 'bn', None, **kwargs), want,
                               rtol=1e-5, atol=1e-6)
