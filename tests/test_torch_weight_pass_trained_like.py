"""The port's weight pass against the JAX package's eager ops, on weights with
a trained network's per-channel spread, and the float-order pieces it rests
on.

Random He-normal weights have one scale for every output channel; a trained
kernel's channels differ in scale by large factors, which is what per-channel
bit allocation (``-baw``) and bias correction (``-bcw``) act on.  So the
weights here are ResNet-18's, at its widths, with log-normal
per-output-channel scales times Laplace entries, drawn with numpy from a
seed.  Bars:
  * the weight pass of naive W4A4, of ``-c laplace -baa -baw`` and of the
    headline recipe (``... -bcw``): every leaf bit-equal to the JAX
    package's under ``jax.disable_jit()``.  The
    correction's per-channel means and standard deviations are summed in
    XLA's CPU order (``ops/bias_corr.xla_cpu_sum``); with ``torch.mean``
    the headline's corrected weights were last-bit apart in about 29 % of the
    elements of the JAX ordering test's trained ResNet-18;
  * ``xla_cpu_sum``, ``xla_cpu_channel_mean`` and ``xla_cpu_channel_std``
    equal eager ``jnp.sum``, ``jnp.mean`` (the sum divided by n; jitted,
    XLA multiplies the same sum by 1/n) and ``jnp.std(ddof=1)``, and
    ``weight_correction`` with ``var_corr`` (``-vcw``) the JAX package's, at
    every layout of kernel the zoo has (input channels 3 to 2048, and the
    classifier);
  * the activation path's per-channel statistics, the op the rest of the
    end-to-end gap traces to (``tests/test_torch_accuracy_band_slow.py``):
    on a post-ReLU batch at the CLI's batch of 256, summed in XLA's order
    they equal eager JAX's bit for bit; the port's ``torch`` reductions are
    closer to the float64 value (1e-6) and within 3e-5 of JAX's; the
    headline's bit widths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.engine import QuantEngine as JEngine
from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.ops import quantizer as j_quantizer
from cnn_quantization_tpu.ops.bias_corr import weight_correction as j_weight_correction
from cnn_quantization_tpu.ops.stats import act_stats_per_channel as j_act_stats_per_channel

from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.ops import quantizer as p_quantizer
from cnn_quantization_tpu_torch.ops.stats import act_stats_per_channel
from cnn_quantization_tpu_torch.ops.bias_corr import (weight_correction, xla_cpu_channel_mean,
                                                      xla_cpu_channel_std, xla_cpu_sum)
from cnn_quantization_tpu_torch.utils.flax_params import (flax_from_state_dict,
                                                          state_dict_from_flax)

from _torch_parity import POLICIES

ACIQ_BA = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
               clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True)
WEIGHT_POLICIES = {
    'naive_w4a4': POLICIES['naive_w4a4'],
    'laplace_baa_baw': ACIQ_BA,
    'headline': POLICIES['headline'],
}


def trained_like(shape, rs):
    """A float32 weight of ``shape`` (output channels first): Laplace entries
    times a log-normal scale per output channel."""
    scale = np.exp(rs.randn(shape[0]) * 0.7) * 0.05
    w = rs.laplace(size=shape) * scale.reshape((-1,) + (1,) * (len(shape) - 1))
    return w.astype(np.float32)


@pytest.fixture(scope='module')
def port_resnet18():
    """(model, meta): the weight pass reads only the state dict and meta, so
    the model is built on ``meta`` without an init."""
    return build_model('resnet18', device='meta')


@pytest.fixture(scope='module')
def resnet18_weights():
    """(the port's state dict, the JAX package's tree) of one draw."""
    model, _ = build_model('resnet18', device='meta')
    rs = np.random.RandomState(2024)
    state = {}
    for name, v in model.state_dict().items():
        shape = tuple(v.shape)
        state[name] = torch.from_numpy(
            trained_like(shape, rs) if len(shape) >= 2
            else (rs.randn(*shape) * 0.05).astype(np.float32))
    return state, flax_from_state_dict(state, 'resnet18')


@pytest.mark.parametrize('name', list(WEIGHT_POLICIES))
def test_weight_pass_equals_eager_jax(resnet18_weights, port_resnet18, name):
    state, tree = resnet18_weights
    policy = dict(WEIGHT_POLICIES[name], arch='resnet18')
    j_model, j_meta = j_build_model('resnet18')
    j_eng = JEngine(j_model, JPolicy(**policy), j_meta)
    with jax.disable_jit():
        want = state_dict_from_flax(jax.device_get(j_eng.quantize_params(tree)), 'resnet18')
    model, meta = port_resnet18
    got = QuantEngine(model, QuantPolicy(**policy), meta).quantize_params(state)
    assert sorted(got) == sorted(want)
    apart = {k: int((got[k] != want[k]).sum()) for k in got}
    assert not any(apart.values()), {k: n for k, n in apart.items() if n}
    # the pass did quantize: a 4-bit conv holds few distinct values a channel
    w = got['layer3.0.conv2.weight']
    assert len(torch.unique(w[0])) <= (2 ** 8 if 'baw' in name or 'headline' in name else 16)
    assert not torch.equal(w, state['layer3.0.conv2.weight'])


# (output channels, input channels, kh, kw) of each path through
# ``xla_cpu_sum``: no reduced dim over 32 (the stem), one over 32 in whole
# windows (3x3 and 1x1 convs), one that pads its windows unevenly, and
# windows that are themselves reduced in windows (2048 inputs); conv and
# classifier layouts
KERNEL_SHAPES = [(64, 3, 7, 7), (64, 64, 3, 3), (256, 256, 3, 3), (128, 64, 1, 1),
                 (16, 33, 5, 5), (1000, 512), (1000, 2048)]


@pytest.mark.parametrize('shape', KERNEL_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_xla_cpu_reductions_equal_eager_jnp(shape):
    w = trained_like(shape, np.random.RandomState(len(shape) * 1000 + shape[1]))
    k = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T   # the JAX package's layout
    axes = tuple(range(k.ndim - 1))
    with jax.disable_jit():
        j = jnp.asarray(k)
        want = [np.asarray(f(j, axis=axes)) for f in (jnp.sum, jnp.mean)]
        want.append(np.asarray(jnp.std(j, axis=axes, ddof=1)))
    t = torch.from_numpy(w)
    got = [xla_cpu_sum(torch.from_numpy(np.ascontiguousarray(k))), xla_cpu_channel_mean(t),
           xla_cpu_channel_std(t)]
    for name, g, want_ in zip(('sum', 'mean', 'std'), got, want):
        np.testing.assert_array_equal(g.numpy(), want_, err_msg=name)
    # torch's own reduction sums in another order: the emulation is needed
    torch_mean = t.mean(dim=tuple(range(1, t.ndim))).numpy()
    assert (torch_mean != want[1]).any() or shape[1] * np.prod(shape[2:]) <= 9
    # under jit the same sum is multiplied by 1/n instead of divided by n
    n = np.float32(np.prod(k.shape[:-1]))
    jitted = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=axes))(jnp.asarray(k)))
    np.testing.assert_array_equal(jitted, got[0].numpy() * (np.float32(1) / n))
    # the correction itself, variance first, on a coarse grid of the weight
    w_q = np.round(w / 0.02).astype(np.float32) * np.float32(0.02)
    k_q = w_q.transpose(2, 3, 1, 0) if w.ndim == 4 else w_q.T
    with jax.disable_jit():
        want_c = np.asarray(j_weight_correction(k, k_q, out_axis=-1, var_corr=True))
    want_c = want_c.transpose(3, 2, 0, 1) if w.ndim == 4 else want_c.T
    got_c = weight_correction(t, torch.from_numpy(w_q), out_axis=0, var_corr=True)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_activation_statistics_summation_order():
    """A post-ReLU NHWC batch of 256 (the CLI's batch; 8x8 maps, 16 channels
    of log-normal scale) and the headline's statistics per channel: the mean,
    the Laplace ``b`` and the std.  Eager JAX's equal ``xla_cpu_sum``'s
    order bit for bit.  That order adds 8192 elements a window one after
    another, so JAX's ``b`` carries a rounding error near 1e-5 relative,
    while the port's ``torch`` reductions lie within 1e-6 of the float64
    value; the two stay within 3e-5 relative of each other.  The bit widths
    of ``-baa`` (Gaussian prior) agree."""
    rs = np.random.RandomState(5)
    scale = np.exp(rs.randn(16) * 0.7).astype(np.float32)
    x = np.maximum(rs.laplace(size=(256, 8, 8, 16)) * scale + 0.3 * scale, 0).astype(np.float32)
    with jax.disable_jit():
        want = {k: np.asarray(v)
                for k, v in j_act_stats_per_channel(jnp.asarray(x), ['mean', 'b', 'std']).items()}
    t = torch.from_numpy(x)
    mean = xla_cpu_channel_mean(t, out_axis=3)
    emulated = {'mean': mean, 'b': xla_cpu_channel_mean((t - mean).abs(), out_axis=3),
                'std': xla_cpu_channel_std(t, out_axis=3)}
    port = act_stats_per_channel(t.permute(0, 3, 1, 2), ['mean', 'b', 'std'])
    x64 = x.astype(np.float64)
    exact = {'mean': x64.mean((0, 1, 2)), 'b': np.abs(x64 - x64.mean((0, 1, 2))).mean((0, 1, 2)),
             'std': x64.std((0, 1, 2), ddof=1)}
    for k, v in want.items():
        np.testing.assert_array_equal(emulated[k].numpy(), v, err_msg=k)
        np.testing.assert_allclose(port[k].numpy(), exact[k], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(port[k].numpy(), v, rtol=3e-5, atol=0, err_msg=k)
    policy = dict(POLICIES['headline'], arch='resnet18')
    with jax.disable_jit():
        bits_j = np.asarray(j_quantizer._act_bit_alloc(
            JPolicy(**policy).tag_configs()['activation'], jnp.asarray(x), None, -1))
    bits_p = p_quantizer._act_bit_alloc(QuantPolicy(**policy).tag_configs()['activation'],
                                        t.permute(0, 3, 1, 2), None, 1).numpy()
    np.testing.assert_array_equal(bits_p, bits_j)
