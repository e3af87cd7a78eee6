"""The port's ResNets against the JAX package's, on identical weights.

Weights are a seeded torchvision-style checkpoint, BN-folded by the JAX
package's importer and moved into the port with ``state_dict_from_flax``;
inputs are numpy, seeded (tests/_torch_parity.py).  Tolerances:
  * site tables: equal (id, tag, half_range, kind; shapes after NHWC->NCHW);
  * teacher-forced sites (each site's quantizer on the JAX model's own
    pre-quantization tensor): every site under 1e-3 relative and the median
    under 1e-6, as tests/test_full_model_parity.py:388-454 requires against
    the reference; against the JAX quantizers run op by op
    (``jax.disable_jit()``), naive W4A4 bit-equal and the headline within
    1e-6 at every site;
  * end-to-end logits: resnet18 at 64x64, batch 2: argmax equal and relative
    error under 2e-3; resnet50 at 32x32: relative error under 5e-2, the chaos
    bound measured at tests/test_full_model_parity.py:467-495 (sub-grid-step
    conv rounding differences flip a few codes and compound over 16 blocks);
  * ``qtype=None``: within 1e-5 relative.
"""

import numpy as np
import pytest
import torch
import jax

from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.engine.qparams import discover_sites as j_discover_sites
from cnn_quantization_tpu.utils.torch_import import state_dict_to_params

from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.utils.flax_params import state_dict_from_flax

from _torch_parity import POLICIES, Pair


@pytest.fixture(scope='module')
def r18():
    return Pair('resnet18', 64)


@pytest.fixture(scope='module')
def r50():
    return Pair('resnet50', 32)


@pytest.mark.parametrize('arch,n_sites', [('resnet18', 23), ('resnet50', 56)])
def test_site_table_equals_jax(arch, n_sites):
    j_model, _ = j_build_model(arch)
    want = j_discover_sites(j_model, (1, 64, 64, 3))
    model, _ = build_model(arch, device='cpu')
    got = discover_sites(model, (1, 3, 64, 64))
    assert len(got) == len(want) == n_sites
    for (s, shape), (sj, shape_j) in zip(got, want):
        assert s.id == sj.id and s.tag == sj.tag
        assert s.half_range == sj.half_range and s.kind == sj.kind
        nhwc = (shape[0], *shape[2:], shape[1]) if len(shape) == 4 else shape
        assert nhwc == tuple(shape_j), s.id


def test_weight_bridge_round_trips(r18):
    sd = state_dict_from_flax(r18.j_params)
    assert set(sd) == set(r18.model.state_dict())
    back = state_dict_to_params({k: v.numpy() for k, v in sd.items()}, fold_bn=False)
    flat = jax.tree_util.tree_leaves_with_path(r18.j_params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), np.asarray(leaf))


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_teacher_forced_sites_resnet18(r18, name):
    rels = r18.teacher_forced(POLICIES[name])
    assert len(rels) == 23
    worst = max(rels, key=rels.get)
    assert rels[worst] < 1e-3, f'site {worst}: teacher-forced rel {rels[worst]:.2e}'
    assert np.median(list(rels.values())) < 1e-6


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_end_to_end_logits_resnet18(r18, name):
    got, want = r18.logits(POLICIES[name])
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-3, f'logit rel err {rel:.2e}'
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_teacher_forced_sites_resnet18_eager_jax(r18, name):
    """As above against the JAX quantizers run op by op: naive W4A4 equal
    bit for bit at every site; the headline's per-channel clip values come
    from statistics summed in another order than XLA's, a few ulps apart."""
    rels = r18.teacher_forced(POLICIES[name], eager=True)
    assert len(rels) == 23
    bar = 0.0 if name == 'naive_w4a4' else 1e-6
    worst = max(rels, key=rels.get)
    assert rels[worst] <= bar, f'site {worst}: teacher-forced rel {rels[worst]:.2e}'


def test_float_passthrough_resnet18(r18):
    got, want = r18.logits(dict(qtype=None))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-5, f'fp32 logit rel err {rel:.2e}'


def test_float_passthrough_resnet18_eager_jax(r18):
    got, want = r18.logits(dict(qtype=None), eager=True)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-5, f'fp32 logit rel err against eager JAX {rel:.2e}'


def test_bottleneck_headline_resnet50(r50):
    """Bottleneck composition: every site teacher-forced, then end-to-end
    logits within the chaos bound."""
    rels = r50.teacher_forced(POLICIES['headline'])
    assert len(rels) == 56
    worst = max(rels, key=rels.get)
    assert rels[worst] < 1e-3, f'site {worst}: teacher-forced rel {rels[worst]:.2e}'
    assert np.median(list(rels.values())) < 1e-6
    got, want = r50.logits(POLICIES['headline'])
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, f'logit rel err {rel:.2e}'


def test_non_ported_arch_raises():
    """Every architecture of the zoo is registered; a name outside it raises."""
    with pytest.raises(ValueError, match="unknown arch 'vgg15'"):
        build_model('vgg15', device='cpu')


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model('resnet18')
