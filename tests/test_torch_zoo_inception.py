"""Inception-v3 (75x75, BN folded with eps 1e-3, non-square filters with
asymmetric padding) and GoogLeNet (64x64, live BNs, ceil_mode pools) in the
port against the JAX package on the CPU: float logits, the W4A4 headline
simulation, W8A8 serving module by module against eager JAX and as a whole
against its float logits (bars and reasons in ``tests/_torch_zoo_family.py``);
and Inception-v3's ``.pth`` route against the JAX importer."""

import numpy as np
import pytest

from cnn_quantization_tpu_torch.utils.checkpoint import import_state

import _torch_zoo_family as fam
from _torch_zoo_family import (one_torch_thread, serving, test_float_logits_match_jax,  # noqa: F401
                               test_prepared_codes_equal_jax,
                               test_serving_modules_match_eager_jax,
                               test_w4a4_headline_simulation_matches_jax)
from _torch_parity import Pair, import_params, torchvision_like_state

SIZES = {'inception_v3': 75, 'googlenet': 64}


@pytest.fixture(scope='module', params=sorted(SIZES))
def pair(request):
    return Pair(request.param, SIZES[request.param])


def test_non_square_filters_are_among_the_modules_held_to_jax():
    """``test_serving_modules_match_eager_jax`` holds one module of each conv
    configuration to eager JAX: for Inception-v3 the 1x7/7x1 and 1x3/3x1
    convs with their asymmetric padding, the 5x5 and the unpadded stride-2
    3x3 are among them."""
    model, _ = fam.build_model('inception_v3', device='meta')
    configs = {fam._config(m) for m in model.modules()
               if isinstance(m, fam.QConv) and m.in_ch != 3}
    kinds = {(c[1], c[2], c[3]) for c in configs}
    assert {((1, 7), (1, 1), (0, 3)), ((7, 1), (1, 1), (3, 0)), ((1, 3), (1, 1), (0, 1)),
            ((3, 1), (1, 1), (1, 0)), ((5, 5), (1, 1), (2, 2)),
            ((3, 3), (2, 2), (0, 0))} <= kinds


@pytest.mark.parametrize('arch', sorted(SIZES))
def test_whole_model_serving_within_bound(arch, record_property):
    out, _ = fam.check_serving_whole(arch, 96)
    record_property(f'{arch}_serving_rel', out)


def test_pth_route_matches_jax_importer():
    """A torchvision-style Inception-v3 checkpoint (made from the port model
    with BN live, plus an aux tower and BN step counters as torchvision's
    carries) through the port's ``.pth`` route gives the JAX importer's
    parameters: the aux tower dropped, BN folded with eps 1e-3."""
    arch = 'inception_v3'
    state = torchvision_like_state(arch)
    state['AuxLogits.conv0.conv.weight'] = np.ones((128, 768, 1, 1), np.float32)
    state['AuxLogits.fc.weight'] = np.ones((1000, 768), np.float32)
    state['Conv2d_1a_3x3.bn.num_batches_tracked'] = np.array(3)
    got = import_state(state, arch, fold_bn=True)
    want = fam.state_dict_from_flax(import_params(arch, state, True), arch)
    assert sorted(got) == sorted(want) and not any(k.startswith('AuxLogits') for k in got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    # eps 1e-5 would fold differently: the route really takes the arch's eps
    wrong = fam.state_dict_from_flax(import_params(arch, state, True), arch)
    k = 'Conv2d_1a_3x3.conv.weight'
    rv = state['Conv2d_1a_3x3.bn.running_var']
    assert float(np.max(np.abs(np.sqrt(rv + 1e-3) / np.sqrt(rv + 1e-5) - 1))) > 1e-4
    np.testing.assert_allclose(got[k], wrong[k].numpy(), rtol=1e-6)
