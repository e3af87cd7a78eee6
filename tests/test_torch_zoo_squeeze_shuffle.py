"""SqueezeNet-1.1 (64x64: fire modules, ceil_mode pools, a conv
classifier) and ShuffleNet (32x32, groups 8: grouped 1x1 convs, the channel
shuffle, depthwise 3x3, an avg-pool shortcut) in the port against the JAX
package on the CPU: float logits, the W4A4 headline simulation, W8A8 serving
module by module against eager JAX and as a whole against its float logits
(bars and reasons in ``tests/_torch_zoo_family.py``)."""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu_torch.models.shufflenet import channel_shuffle

import _torch_zoo_family as fam
from _torch_zoo_family import (one_torch_thread, serving, test_float_logits_match_jax,  # noqa: F401
                               test_prepared_codes_equal_jax,
                               test_serving_modules_match_eager_jax,
                               test_w4a4_headline_simulation_matches_jax)
from _torch_parity import Pair

SIZES = {'squeezenet1_1': 64, 'shufflenet': 32}


@pytest.fixture(scope='module', params=sorted(SIZES))
def pair(request):
    return Pair(request.param, SIZES[request.param])


@pytest.mark.parametrize('arch', ['squeezenet1_0', 'shufflenet'])
def test_whole_model_serving_within_bound(arch, record_property):
    out, scales = fam.check_serving_whole(arch, 64)
    record_property(f'{arch}_serving_rel', out)
    vectors = {k: v for k, v in scales.items() if np.ndim(v) == 1}
    if arch == 'shufflenet':
        # the grouped 1x1 convs freeze per-group [in_ch] vectors, the
        # depthwise 3x3 per-channel ones; stage 2's first 1x1 (groups 1) a scalar
        model, _ = fam.build_model(arch, device='meta', input_size=64)
        grouped = {m.site.id: m.groups for m in model.modules()
                   if isinstance(m, fam.QConv) and m.groups > 1}
        assert set(vectors) == set(grouped)
        for k, v in vectors.items():
            per_group = v.reshape(grouped[k], -1)
            assert (per_group == per_group[:, :1]).all(), k
        assert np.ndim(scales['conv1_activation']) == 0
    else:
        assert not vectors


def test_channel_shuffle_is_jax_order_and_channels_last():
    x = torch.arange(2 * 16 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3, 16)
    got = channel_shuffle(x.permute(0, 3, 1, 2), 8)
    want = x.reshape(2, 3, 3, 8, 2).transpose(3, 4).reshape(2, 3, 3, 16)   # JAX's NHWC shuffle
    assert torch.equal(got.permute(0, 2, 3, 1), want)
    assert got.is_contiguous(memory_format=torch.channels_last)
