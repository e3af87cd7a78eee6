"""The port's copy of the JAX package's accuracy-ordering task
(``tests/test_accuracy_ordering.py``) at small sizes on the CPU: the
dataset bit for bit, the truncated He-normal init against Flax's, three
training steps against the JAX test's ``_train``, and ``chip_smoke.py``'s
slice-11 phase ``accuracy_path`` rehearsed with stand-ins for the kernels'
launches (``tests/test_torch_chip_zoo_path.py``), its float-order band at 2
draws.  On the card the phase trains 1000 steps at batch 128, runs the six
configurations on 2048 images at batch 256 and the band at 16 draws through
the kernels themselves; the whole ordering on the CPU is
``tests/test_torch_accuracy_ordering_slow.py`` and the band against the JAX
package ``tests/test_torch_accuracy_band_slow.py`` (both gated)."""

import json
from collections import Counter

import jax
import numpy as np
import torch
from flax import linen as nn

import chip_smoke
import test_accuracy_ordering as jtest
from cnn_quantization_tpu.engine import TapContext as JTapContext
from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear, init_parameters
from cnn_quantization_tpu_torch.utils.flax_params import (flax_from_state_dict,
                                                          state_dict_from_flax)
from test_torch_chip_zoo_path import stand_in_kernels  # noqa: F401  (a fixture)

TRUNCATION = 2 / 0.87962566103423978   # Flax's cut, in units of the target std


def test_dataset_is_the_jax_tests():
    (xtr, ytr), (xte, yte) = chip_smoke.make_dataset(0)
    (jxtr, jytr), (jxte, jyte) = jtest.make_dataset(0)
    for got, want in ((xtr, jxtr), (ytr, jytr), (xte, jxte), (yte, jyte)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert xtr.shape == (4000, 32, 32, 3) and xte.shape == (2048, 32, 32, 3)


def test_init_draws_flax_he_normal():
    """A ``(64, 64, 3, 3)`` conv and a 576-in linear from ``init_parameters``
    against ``nn.initializers.he_normal()`` at the same fan-in: the std
    sqrt(2 / 576) within 2 %, every value inside the truncation at
    2 / 0.8796 of it and the largest near it (a plain normal of 36864 draws
    reaches past 4 of its std), biases zero."""
    model = torch.nn.ModuleList([QConv(64, 64, 3), QLinear(576, 64)])
    init_parameters(model, seed=0)
    want_std = (2 / 576) ** 0.5
    flax = np.asarray(nn.initializers.he_normal()(jax.random.PRNGKey(0), (3, 3, 64, 64)))
    for w in (model[0].weight.detach().numpy(), model[1].weight.detach().numpy(), flax):
        assert abs(w.std() / want_std - 1) < 0.02
        assert TRUNCATION * 0.98 < np.abs(w).max() / want_std <= TRUNCATION
    assert abs(model[0].weight.std().item() / flax.std() - 1) < 0.02
    assert not model[0].bias.any() and not model[1].bias.any()


def test_three_steps_match_jax_train():
    """Three Adam steps at batch 8 from the JAX test's own initial params
    (``PRNGKey(0)``, carried across) against ``_train(steps=3, batch=8)``,
    leaf by leaf, relative in norm: kernels within 1e-3, biases within 1e-2.
    Adam's first step moves every element by about lr whatever its
    gradient's size, so an element whose gradient is near 0 steps the other
    way in the other package's float order (after one step 1-3 elements of a
    kernel differ, by up to 2 lr), and the later steps spread that; an
    elementwise bar would test that noise.  The biases start at 0 and hold
    three such steps, so the same spread is larger against their norm.
    Measured on the CPU: kernels 4.7e-4 at most, biases 4.1e-3 (the largest
    element 0.12 lr apart); with Adam's beta2 0.99 instead of 0.999 the
    biases are 1.9e-2 apart."""
    model, _ = j_build_model('resnet18')
    x0 = jax.numpy.zeros((2, 32, 32, 3), jax.numpy.float32)
    init = jax.jit(lambda k: model.init(k, x0, JTapContext())['params'])(jax.random.PRNGKey(0))
    want, _ = jtest._train(steps=3, batch=8)
    got, _, _, rep = chip_smoke.train_ordering_net(
        torch.device('cpu'), steps=3, batch=8, init=state_dict_from_flax(jax.device_get(init),
                                                                         'resnet18'))
    got = flax_from_state_dict(got.state_dict(), 'resnet18')
    want = jax.device_get(want)
    flat_got, flat_want = ({jax.tree_util.keystr(k): v
                            for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
                           for t in (got, want))
    assert sorted(flat_got) == sorted(flat_want) and len(flat_got) == 42
    gaps = {k: float(np.linalg.norm(flat_got[k] - v) / np.linalg.norm(v))
            for k, v in flat_want.items()}
    for k, gap in gaps.items():
        assert gap <= (1e-3 if k.endswith("['kernel']") else 1e-2), (k, gap)
    assert rep['steps'] == 3 and np.isfinite(rep['last10_loss'])


def test_accuracy_path_phase_on_cpu(stand_in_kernels, capsys):  # noqa: F811
    rep = chip_smoke.accuracy_path(torch.device('cpu'), 'cpu', steps=2, n_test=64, batch=32,
                                   draws=2)
    configs = rep['configs']
    assert list(configs) == list(chip_smoke.ORDERING_CONFIGS)
    # 21 weights (20 convs, the classifier), 23 activation sites, 2 batches
    # of 32.  Under a clipper every site is affine but the max-pool output's
    # and the classifier input's (8-bit, unclipped: per-tensor min/max); under
    # naive -pcq_a 7 sites run per tensor, the last stage's 1x1 maps among them
    want = {
        'fp32': ({}, {}),
        'w8a8': ({'reference_per_tensor': 21 + 2 * 23}, {}),
        'naive_w4a4': ({'affine': 21 + 2 * 16, 'reference_per_tensor': 2 * 7}, {}),
        'headline': ({'affine': 21 + 2 * 21, 'reference_per_tensor': 2 * 2}, {}),
        '2std': ({'reference_per_tensor': 21 + 2 * 2, 'affine': 2 * 21}, {}),
        # the weight pass, then 2 calibration and 2 evaluated forwards
        'w8a8_serving': ({'reference_per_tensor': 21}, {'wgmma': 4, 'im2col_wgmma': 4 * 19}),
    }
    for name, (modes, routes) in want.items():
        entry = configs[name]
        assert entry['fake_quant_modes'] == entry['predicted_fake_quant_modes'] == modes, name
        assert entry['routes'] == entry['predicted_routes'] == routes, name
        assert np.isfinite(entry['top1']) and entry['images_per_sec'] > 0
    # the band: 3 runs (unperturbed, 2 draws) of each 4-bit recipe
    band = rep['band']
    band_modes = Counter()
    for name in chip_smoke.BAND_CONFIGS:
        band_modes.update({mode: 3 * n for mode, n in want[name][0].items()})
    assert band['fake_quant_modes'] == dict(band_modes)
    assert band['launches'] == {'fake_quant': 3 * 3 * (21 + 2 * 23)}
    assert list(band['configs']) == list(chip_smoke.BAND_CONFIGS)
    for entry in band['configs'].values():
        assert len(entry['top1']['draws']) == 2 and np.isfinite(entry['top1']['mean'])
        assert entry['top1']['min'] <= entry['top1']['mean'] <= entry['top1']['max']
    assert list(band['ordering_held_in_draws']) == list(
        chip_smoke.ordering_holds({n: 0.0 for n in chip_smoke.ORDERING_CONFIGS}))
    assert all(0 <= n <= 2 for n in band['ordering_held_in_draws'].values())
    assert rep['launches'] == {'fake_quant': 21 * 5 + 2 * 23 * 4 + 3 * 3 * (21 + 2 * 23),
                               'int8_gemm': 4, 'int8_conv': 4 * 19}
    assert rep['headline_kernel_vs_plain']['dynamic']['rel_err'] == 0.0
    assert 'frozen' not in rep['headline_kernel_vs_plain']
    assert rep['serving_kernel_vs_plain']['rel_err'] == 0.0
    assert set(rep['cpu']) == {'fp32', 'w8a8_serving', *chip_smoke.BAND_CONFIGS}
    for name, entry in rep['cpu'].items():
        assert entry['top1'] == configs[name]['top1']
    assert rep['train']['steps'] == 2 and np.isfinite(rep['train']['last10_loss'])
    out = capsys.readouterr().out
    line = json.loads(next(ln for ln in out.splitlines() if '"phase": "accuracy_path"' in ln))
    assert line['launches'] == rep['launches'] and line['configs'] == json.loads(
        json.dumps(configs))
