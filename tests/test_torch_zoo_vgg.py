"""VGG-16-BN (64x64) and AlexNet (96x96) in the port against the JAX package
on the CPU: float logits, the W4A4 headline simulation, W8A8 serving module by
module against eager JAX and as a whole against its float logits (bars and
reasons in ``tests/_torch_zoo_family.py``); the flatten order of the feature
map ahead of the classifier; and the ``.pth`` route against the JAX
importer."""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu_torch.engine import TapContext
from cnn_quantization_tpu_torch.models.vgg import flatten_hwc
from cnn_quantization_tpu_torch.utils.checkpoint import import_state, to_hwc_flatten_order
from cnn_quantization_tpu_torch.utils.device import nhwc_to_nchw

import _torch_zoo_family as fam
from _torch_zoo_family import (one_torch_thread, serving, test_float_logits_match_jax,  # noqa: F401
                               test_prepared_codes_equal_jax,
                               test_serving_modules_match_eager_jax,
                               test_w4a4_headline_simulation_matches_jax)
from _torch_parity import Pair, flatten_inputs_at, import_params, torchvision_like_state

SIZES = {'vgg16_bn': 64, 'alexnet': 96}


@pytest.fixture(scope='module', params=sorted(SIZES))
def pair(request):
    return Pair(request.param, SIZES[request.param])


@pytest.mark.parametrize('arch,size', [('vgg16', 64), ('vgg16_bn', 64), ('alexnet', 96)])
def test_whole_model_serving_within_bound(arch, size, record_property):
    out, _ = fam.check_serving_whole(arch, size)
    record_property(f'{arch}_serving_rel', out)


def test_vgg_flattens_hwc_like_jax():
    """At 64x64 VGG's last feature map is 2x2, so the JAX model's NHWC
    flatten and an NCHW flatten order the classifier input differently.  The
    port's classifier input is JAX's order; the (C, H, W) order is not (the
    float logits test above would fail on it too)."""
    pair = Pair('vgg16_bn', 64)
    seen = {}
    hooks = [pair.model.features[-1].register_forward_hook(
                 lambda _m, _a, out: seen.__setitem__('map', out.detach())),
             pair.model.classifier[0].register_forward_pre_hook(
                 lambda _m, args: seen.__setitem__('flat', args[0].detach()))]
    try:
        torch.func.functional_call(pair.model, pair.params,
                                   (nhwc_to_nchw(pair.x, 'cpu'), TapContext()))
    finally:
        for h in hooks:
            h.remove()
    fmap = seen['map']
    assert tuple(fmap.shape) == (2, 512, 2, 2)
    want = fmap.permute(0, 2, 3, 1).numpy().reshape(2, -1)   # JAX's NHWC reshape
    np.testing.assert_array_equal(seen['flat'].numpy(), want)
    np.testing.assert_array_equal(flatten_hwc(fmap).numpy(), want)
    assert not np.array_equal(fmap.flatten(1).numpy(), want)


def test_pth_route_matches_jax_importer():
    """A torchvision-style vgg16_bn checkpoint (made from the port model at
    64x64, BN live, with BN step counters) through the port's ``.pth`` route
    gives the JAX importer's parameters: BN folded, the first classifier
    permuted from (C, H, W) to (H, W, C) order."""
    arch, size = 'vgg16_bn', 64
    state = torchvision_like_state(arch, size=size)
    state.update({k.replace('running_mean', 'num_batches_tracked'): np.array(7)
                  for k in list(state) if k.endswith('running_mean')})
    got = import_state(state, arch, fold_bn=True)
    want = fam.state_dict_from_flax(import_params(arch, state, True, size), arch)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    w = state['classifier.0.weight']
    assert not np.array_equal(got['classifier.0.weight'], w)
    np.testing.assert_array_equal(got['classifier.0.weight'], to_hwc_flatten_order(w, 512))
    assert flatten_inputs_at(arch, size) == {'vgg16': {'classifier_0': (512, 2, 2)}}
    with pytest.raises(ValueError, match='square map'):
        to_hwc_flatten_order(np.zeros((4, 512 * 6)), 512)
