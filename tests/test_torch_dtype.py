"""The model dtype (bfloat16 activations, float32 parameters) in the port
against the JAX package's bf16 model: resnet18 at 64x64 on the CPU, the same
BN-folded weights and numpy-seeded input in both.

Tolerances and their reasons:

  * each ``QConv``/``QLinear`` of the float path, fed the bf16 input the port's
    own forward gave it, against the JAX layer on the same input and weights:
    within one bf16 ulp (2^-7 relative) of the larger of the output and the
    bias-free sum.  JAX rounds ``sum + bias`` once from float32; ``F.conv2d``
    hands back a bf16 sum, to which the port adds the float32 bias in float32
    and rounds again, so where the bias cancels the sum the first rounding
    (half an ulp of the SUM) shows in the smaller result;
  * a serving conv and the serving classifier (int8 kernels' plain versions,
    ``out_dtype`` bf16) against the un-jitted JAX layer on the same codes and
    scales: one bf16 ulp of the output (one float32 value rounded once in
    both);
  * whole-model float logits: 2e-2 relative L2 with equal argmax (6.5e-3
    measured: twenty bf16 layers, each rounding where the other may not);
  * ``QTensor.dequant(bfloat16)``/``PackedQTensor.dequant(bfloat16)``: exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine import TapContext as JTapContext
from cnn_quantization_tpu.engine.context import ServingInt8Context as JServingContext
from cnn_quantization_tpu.models import layers as j_layers
from cnn_quantization_tpu.ops.kernels.int4_matmul import pack_int4 as j_pack_int4

from cnn_quantization_tpu_torch.engine import TapContext
from cnn_quantization_tpu_torch.engine.context import ServingInt8Context
from cnn_quantization_tpu_torch.models.layers import (PackedQTensor, QBatchNorm, QConv, QLinear,
                                                      QTensor)
from cnn_quantization_tpu_torch.ops.kernels.int4_matmul import pack_int4
from cnn_quantization_tpu_torch.utils.device import nhwc_to_nchw

from _torch_parity import Pair

ARCH, SIZE = 'resnet18', 64
ULP = 2.0 ** -7   # bf16 keeps 8 significant bits


def _bf16(t):
    """A bf16 tensor as float32 numpy (numpy has no bfloat16)."""
    return t.float().numpy()


def _j_bf16(a):
    return np.asarray(a.astype(jnp.float32))


def _to_jax(t):
    """A bf16 torch tensor as a bf16 jax array of the same values."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope='module')
def pair():
    return Pair(ARCH, SIZE, dtype='bfloat16')


def _layer_calls(pair):
    """(name, module, bf16 input, output) of every conv and linear of one
    float forward of the port's model."""
    calls, hooks = [], []
    for name, m in pair.model.named_modules():
        if isinstance(m, (QConv, QLinear)):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: calls.append((name, mod, args[0], out))))
    with torch.no_grad():
        logits = pair.model(nhwc_to_nchw(pair.x, 'cpu'), TapContext())
    for h in hooks:
        h.remove()
    return calls, logits


def _j_layer(mod, name, pair):
    """The JAX layer with ``mod``'s configuration and the JAX tree's weights."""
    node = pair.j_params
    for seg in name.replace('.0', '_0').replace('.1', '_1').split('.'):
        node = node[seg]
    if isinstance(mod, QConv):
        layer = j_layers.QConv(mod.features, tuple(mod.weight.shape[2:]), mod.strides,
                               mod.padding, groups=mod.groups, use_bias=mod.bias is not None,
                               dtype=jnp.bfloat16)
    else:
        layer = j_layers.QLinear(mod.weight.shape[0], use_bias=mod.bias is not None,
                                 dtype=jnp.bfloat16)
    return layer, {'params': node}


def test_model_carries_the_dtype(pair):
    assert pair.model.dtype == torch.bfloat16
    convs = [m for m in pair.model.modules() if isinstance(m, (QConv, QLinear))]
    assert len(convs) == 21 and all(m.dtype == torch.bfloat16 for m in convs)
    assert all(p.dtype == torch.float32 for p in pair.model.parameters())   # as in Flax
    assert QBatchNorm(4).dtype == torch.float32


def test_each_float_layer_within_one_ulp_of_jax(pair):
    calls, _ = _layer_calls(pair)
    assert len(calls) == 21
    for name, mod, x, y in calls:
        assert y.dtype == torch.bfloat16, name
        x_j = _to_jax(x.to(torch.bfloat16))
        if x_j.ndim == 4:
            x_j = x_j.transpose(0, 2, 3, 1)
        layer, variables = _j_layer(mod, name, pair)
        want = _j_bf16(layer.apply(variables, x_j, JTapContext()))
        got = _bf16(y.permute(0, 2, 3, 1) if y.ndim == 4 else y)
        bias = mod.bias.detach().numpy()
        reach = np.maximum(np.abs(want), np.abs(want - bias))   # output, bias-free sum
        over = np.abs(got - want) > ULP * reach + 1e-30
        assert not over.any(), (name, int(over.sum()), float(np.abs(got - want).max()))


def test_float_logits_match_jax_bf16_model(pair, record_property):
    _, logits = _layer_calls(pair)
    want = np.asarray(pair.j_model.apply({'params': pair.j_params}, jnp.asarray(pair.x),
                                         JTapContext()))
    assert logits.dtype == torch.float32 and want.dtype == np.float32
    rel = float(np.linalg.norm(logits.numpy() - want) / np.linalg.norm(want))
    record_property('bf16_logits_rel', rel)
    assert rel <= 2e-2, rel
    assert (logits.numpy().argmax(-1) == want.argmax(-1)).all()


def test_serving_layers_write_the_dtype_within_one_ulp(pair):
    """A prepared 3x3 conv and the classifier under a serving context with
    frozen scales: the int8 product is exact and its float32 epilogue is
    rounded to bf16 once in both packages."""
    rng = np.random.RandomState(5)
    conv = pair.model.layer1[0].conv1
    w = np.clip(np.round(rng.randn(64, 64, 3, 3) * 40), -127, 127).astype(np.int8)
    w_scale = (rng.rand(64) * 1e-2 + 1e-3).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    x = rng.randn(2, 64, 16, 16).astype(np.float32)
    scales = {conv.site.id: 0.03}
    params = {'weight': torch.from_numpy(w).contiguous(memory_format=torch.channels_last),
              'w_scale': torch.from_numpy(w_scale), 'bias': torch.from_numpy(bias)}
    with torch.no_grad():
        got = torch.func.functional_call(
            conv, params, (torch.from_numpy(x).bfloat16(), ServingInt8Context(act_scales=scales)))
    assert got.dtype == torch.bfloat16
    layer = j_layers.QConv(64, 3, 1, 1, site=conv.site, dtype=jnp.bfloat16)
    j_params = {'kernel': jnp.asarray(w.transpose(2, 3, 1, 0)), 'w_scale': jnp.asarray(w_scale),
                'bias': jnp.asarray(bias)}
    with jax.disable_jit():
        want = _j_bf16(layer.apply({'params': j_params},
                                   _to_jax(torch.from_numpy(x).bfloat16()).transpose(0, 2, 3, 1),
                                   JServingContext(act_scales=scales)))
    diff = np.abs(_bf16(got.permute(0, 2, 3, 1)) - want)
    assert not (diff > ULP * np.abs(want) + 1e-30).any(), float(diff.max())

    fc = pair.model.fc
    wl = np.clip(np.round(rng.randn(1000, 512) * 40), -127, 127).astype(np.int8)
    wl_scale = (rng.rand(1000) * 1e-2 + 1e-3).astype(np.float32)
    bl = rng.randn(1000).astype(np.float32)
    xl = rng.randn(2, 512).astype(np.float32)
    scales = {fc.site.id: 0.02}
    with torch.no_grad():
        got = torch.func.functional_call(
            fc, {'weight': torch.from_numpy(wl), 'w_scale': torch.from_numpy(wl_scale),
                 'bias': torch.from_numpy(bl)},
            (torch.from_numpy(xl).bfloat16(), ServingInt8Context(act_scales=scales)))
    assert got.dtype == torch.bfloat16
    layer = j_layers.QLinear(1000, site=fc.site, dtype=jnp.bfloat16)
    with jax.disable_jit():
        want = _j_bf16(layer.apply(
            {'params': {'kernel': jnp.asarray(wl.T), 'w_scale': jnp.asarray(wl_scale),
                        'bias': jnp.asarray(bl)}},
            _to_jax(torch.from_numpy(xl).bfloat16()), JServingContext(act_scales=scales)))
    diff = np.abs(_bf16(got) - want)
    assert not (diff > ULP * np.abs(want) + 1e-30).any(), float(diff.max())


def test_dequant_to_bfloat16_is_exact():
    rng = np.random.RandomState(6)
    codes = rng.randint(-127, 128, (2, 5, 5, 256)).astype(np.int8)        # NHWC
    scale = np.float32(0.0371)
    want = _j_bf16(j_layers.QTensor(jnp.asarray(codes), jnp.float32(scale)).dequant(jnp.bfloat16))
    got = QTensor(torch.from_numpy(codes).permute(0, 3, 1, 2), torch.tensor(scale)).dequant(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16(got.permute(0, 2, 3, 1)), want)
    assert QTensor(torch.from_numpy(codes), torch.tensor(scale)).dequant().dtype == torch.float32

    nibbles = rng.randint(-7, 8, (2, 5, 5, 256)).astype(np.int8)
    j_packed = j_layers.PackedQTensor(j_pack_int4(jnp.asarray(nibbles)), jnp.float32(scale))
    packed = PackedQTensor(pack_int4(torch.from_numpy(nibbles)).permute(0, 3, 1, 2),
                           torch.tensor(scale))
    got = packed.dequant(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16(got.permute(0, 2, 3, 1)),
                                  _j_bf16(j_packed.dequant(jnp.bfloat16)))
