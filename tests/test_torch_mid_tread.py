"""The port's mid-tread quantization against the JAX package's, eager on both
sides, on the same seeded numpy inputs.

Tolerances:
  * the step ``delta``: within 1e-6 relative (it comes from a std, a mean and
    a mean absolute deviation, whose reduction order differs between XLA and
    PyTorch);
  * the codes: equal within 1e-5 relative (a code clamped to the window
    c_max = mean/delta + omega/2 is not an integer and carries delta's ulp
    differences), except where a delta differing in its last bit puts a
    value on a rounding tie of ``torch.round``/``jnp.round`` (half to even):
    there a code may flip by one step, at under 0.1 % of the elements.
  * values: the same, a flipped code moving its value by one delta.
NHWC activations are transposed to the port's NCHW, HWIO weights to OIHW.
"""

import jax
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.engine.context import QuantizeContext as JQuantizeContext
from cnn_quantization_tpu.engine.policy import QuantPolicy as JPolicy
from cnn_quantization_tpu.ops import mid_tread as j_mt
from cnn_quantization_tpu.ops import quantizer as j_q

from cnn_quantization_tpu_torch.engine.context import QuantizeContext, Site
from cnn_quantization_tpu_torch.engine.policy import QuantPolicy
from cnn_quantization_tpu_torch.ops import mid_tread as mt
from cnn_quantization_tpu_torch.ops import quantizer as q
from cnn_quantization_tpu_torch.utils import counters

FLIP_FRAC = 1e-3


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def rows(shape, seed):
    """Laplace rows of differing scale and mean: channels as the mid-tread
    allocation sees them."""
    rng = np.random.RandomState(seed)
    return (rng.laplace(0, 1, shape) * rng.uniform(0.1, 3, (shape[0], 1))
            + rng.uniform(-0.5, 0.5, (shape[0], 1))).astype(np.float32)


def assert_codes_close(ours, ref, step=1.0):
    """Equal within 1e-5 relative, or one ``step`` off at under FLIP_FRAC of
    the elements (rounding ties)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(ours - ref)
    flipped = diff > 1e-5 * np.abs(ref) + 1e-6
    step = np.broadcast_to(step, diff.shape)
    assert np.all(diff[flipped] <= step[flipped] * 1.001 + 1e-6), diff.max()
    assert flipped.mean() < FLIP_FRAC, f'{flipped.mean():.2e} of the elements flipped'


CASES = [(clip, sym, bits) for clip in (True, False) for sym in (True, False)
         for bits in (2, 4, 5.3)]


@pytest.mark.parametrize('shape', [(8, 4000), (1, 20000), (64, 300)],
                         ids=['per_channel', 'per_tensor', 'many_channels'])
@pytest.mark.parametrize('clip,sym,bits', CASES,
                         ids=[f'clip{int(c)}-sym{int(s)}-{b}b' for c, s, b in CASES])
def test_mid_tread_quantize_matches_jax(shape, clip, sym, bits):
    t = rows(shape, seed=shape[0])
    with jax.disable_jit():
        want = j_mt.mid_tread_quantize(t, bits, clip=clip, sym=sym)
    got = mt.mid_tread_quantize(torch.from_numpy(t), bits, clip=clip, sym=sym)
    w_delta = np.asarray(want.delta)
    np.testing.assert_allclose(got.delta.numpy(), w_delta, rtol=1e-6)
    assert_codes_close(got.codes.numpy(), want.codes)
    assert_codes_close(got.values.numpy(), want.values, step=w_delta[:, None])


def test_empty_channel_gets_the_largest_finite_step():
    """A channel allocated no bin (omega rounds to 0) takes delta = float32
    max, so its division stays finite and its codes are 0, in both packages."""
    t = rows((16, 200), seed=5)
    t[3] *= 1e-6   # a near-constant channel: its sigma^(2/3) share rounds to 0 bins
    with jax.disable_jit():
        want = j_mt.mid_tread_quantize(t, 2, clip=False, sym=True)
    got = mt.mid_tread_quantize(torch.from_numpy(t), 2, clip=False, sym=True)
    assert float(got.delta[3]) == float(np.asarray(want.delta)[3]) == mt._F32_MAX
    assert torch.all(got.codes[3] == 0) and np.all(np.isfinite(got.values.numpy()))


@pytest.mark.parametrize('per_channel', [True, False], ids=['per_channel', 'per_tensor'])
@pytest.mark.parametrize('entropy', [True, False], ids=['entropy', 'no_entropy'])
def test_mid_tread_quantize_tensor_matches_jax(per_channel, entropy):
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 6, 6, 8) * np.linspace(0.2, 3, 8)).astype(np.float32)
    with jax.disable_jit():
        want, w_ent = j_mt.mid_tread_quantize_tensor(
            x, 4, clip=True, sym=True, per_channel=per_channel, channel_axis=-1,
            measure_entropy=entropy)
    got, ent = mt.mid_tread_quantize_tensor(nchw(x), 4, clip=True, sym=True,
                                            per_channel=per_channel, channel_axis=1,
                                            measure_entropy=entropy)
    assert got.shape == (2, 8, 6, 6) and got.dtype == torch.float32
    want = np.asarray(want)
    assert_codes_close(to_nhwc(got), want, step=np.abs(want).max() / 4)
    assert (ent is None) == (w_ent is None) == (not entropy)
    if entropy:
        assert abs(float(ent) - float(w_ent)) < 1e-5
        assert 0.0 < float(ent) <= 8.0


@pytest.mark.parametrize('half', [False, True], ids=['sym', 'half_range'])
@pytest.mark.parametrize('pcq_a', [True, False], ids=['pcq_a', 'per_tensor'])
def test_quantize_activation_mid_tread_matches_jax(half, pcq_a):
    """The quantizer's mid-tread branch (JAX ops/quantizer.py:209-216): the
    clip is on, the window symmetric unless the site is half-range, per
    channel under -pcq_a; the entropy reaches aux."""
    rng = np.random.RandomState(12)
    x = (rng.randn(2, 6, 6, 8) * np.linspace(0.2, 3, 8) + 0.3).astype(np.float32)
    if half:
        x = np.maximum(x, 0.0)
    kw = dict(num_bits=4, pcq_a=pcq_a, clipping='laplace', mtd_quant=True,
              bit_alloc_target_act=5.3, measure_entropy=True)
    with jax.disable_jit():
        want, w_aux = j_q.quantize_activation(x, j_q.QuantConfig(**kw), half_range=half)
    before = counters.snapshot()
    got, aux = q.quantize_activation(nchw(x), q.QuantConfig(**kw), half_range=half)
    assert counters.since(before) == {}
    want = np.asarray(want)
    assert_codes_close(to_nhwc(got), want, step=np.abs(want).max() / 4)
    assert abs(float(aux['entropy']) - float(w_aux['entropy'])) < 1e-5
    assert 0.0 in to_nhwc(got)   # the mid-tread grid holds 0 exactly


@pytest.mark.parametrize('target', [None, 3.5], ids=['bits', 'target_weight'])
def test_quantize_weight_mid_tread_matches_jax(target):
    """The weight branch (JAX ops/quantizer.py:326-333): per output channel,
    no clip, symmetric range max - min."""
    rng = np.random.RandomState(9)
    w = (rng.randn(3, 3, 4, 16) * np.linspace(0.1, 5, 16)).astype(np.float32)
    kw = dict(num_bits=4, pcq_w=True, mtd_quant=True, bit_alloc_target_weight=target,
              measure_entropy=True)
    with jax.disable_jit():
        want, w_aux = j_q.quantize_weight(w, j_q.QuantConfig(**kw), out_axis=-1)
    got, aux = q.quantize_weight(oihw(w), q.QuantConfig(**kw), out_axis=0)
    want = np.asarray(want)
    assert_codes_close(got.numpy().transpose(2, 3, 1, 0), want)
    assert abs(float(aux['entropy']) - float(w_aux['entropy'])) < 1e-5


def test_mid_tread_sites_through_the_context_match_jax():
    """-mtq through the tap context: activation and avgpool ('default' tag)
    sites go mid-tread, the classifier and pooling sites stay on the affine
    grid; per-site entropy and numel reach the aux as in JAX."""
    kw = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
              clipping='laplace', bit_alloc_act=True, mtd_quant=True, measure_entropy=True,
              arch='resnet18')
    rng = np.random.RandomState(4)
    sites = [Site('conv3_activation', 'activation', half_range=True),
             Site('conv4_activation', 'activation'),
             Site('avgpool0_out', 'default', kind='avgpool'),
             Site('maxpool0_out', 'activation_pooling', kind='maxpool')]
    j_ctx, ctx = JQuantizeContext(JPolicy(**kw)), QuantizeContext(QuantPolicy(**kw))
    for site in sites:
        x = (rng.randn(2, 5, 5, 8) * np.linspace(0.5, 2, 8)).astype(np.float32)
        with jax.disable_jit():
            want = np.asarray(j_ctx.tap(x, site))
        got = to_nhwc(ctx.tap(nchw(x), site))
        assert_codes_close(got, want, step=np.abs(want).max() / 4)
    j_aux = j_ctx.finalize()
    aux = ctx.finalize()
    assert sorted(aux) == sorted(j_aux)
    for k, v in j_aux.items():
        assert abs(float(aux[k]) - float(v)) < 1e-5, k
