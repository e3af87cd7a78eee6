"""The rest of the ResNet family in the port's registry against the JAX
package's, on the CPU at 64x64.

For resnet34 (BasicBlock, folded), resnext50_32x4d (grouped 3x3 convs, live
BNs: 'resnext' holds no 'resnet', so the reference's rule neither folds nor
marks it) and wide_resnet50_2 (folded and marked): the registry's ``fold_bn``,
the site table, and the float and W4A4-simulation logits from one
torchvision-style checkpoint carried across by the weight bridge.  Tolerances:
float logits 1e-3 relative L2 (float32 sums in another order); the simulation
1e-3 per teacher-forced site and 0.1 end to end with equal argmax (see the
test for why 2e-3 cannot hold on a deep 4-bit trunk).  ResNeXt's serving path
is held to eager JAX block by block (teacher-forced, per-group scale vectors
channel by channel); its whole-model serving test beside that checks the
registry's build against its own float logits.  For the 101- and 152-layer
variants the site table alone, on modules that are built but not initialised.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine.context import ServingInt8Context as JServingInt8Context
from cnn_quantization_tpu.engine.qparams import discover_sites as j_discover_sites
from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.models.resnet import Bottleneck as JBottleneck

from cnn_quantization_tpu_torch.engine.context import ServingInt8Context
from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import available_archs, build_model
from cnn_quantization_tpu_torch.models.resnet import build_resnet
from cnn_quantization_tpu_torch.models.zoo import _FOLDED
from cnn_quantization_tpu_torch.utils.flax_params import (act_scales_from_jax,
                                                          state_dict_from_flax)

from _torch_parity import (POLICIES, JEngine, JPolicy, Pair, QuantEngine, QuantPolicy,
                           site_table)

SIZE = 64
SMALL = ('resnet34', 'resnext50_32x4d', 'wide_resnet50_2')
DEEP = ('resnet101', 'resnet152', 'resnext101_32x8d', 'wide_resnet101_2')


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """PyTorch on one thread: the plain int32 grouped convolution of the CPU
    is slow, and under a parallel test run its OpenMP barriers wait on
    descheduled threads for minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=SMALL)
def pair(request):
    return Pair(request.param, SIZE)


def test_registry_folds_as_the_reference_rule(pair):
    assert pair.meta.fold_bn == pair.j_meta.fold_bn == ('resnet' in pair.arch)
    assert pair.meta.arch == pair.j_meta.arch == pair.arch


def test_site_table_equals_jax(pair):
    want = site_table(j_discover_sites(pair.j_model, (1, SIZE, SIZE, 3)), nhwc=True)
    got = site_table(discover_sites(pair.model, (1, 3, SIZE, SIZE)), nhwc=False)
    assert got == want
    # live BNs are sites of their own: 53 convs + 53 BNs + 2 pools + fc
    assert len(got) == {'resnet34': 39, 'resnext50_32x4d': 109, 'wide_resnet50_2': 56}[pair.arch]
    marked = any(hr for _, _, hr, _, _ in got)
    assert marked == ('resnet' in pair.arch)


def test_float_logits_match_jax(pair):
    got, want = pair.logits({})
    assert _rel(got, want) <= 1e-3
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_w4a4_simulation_matches_jax(pair, record_property):
    """Site by site (both quantizers fed the float model's own tensor, so
    nothing compounds) the simulation agrees to 1e-3, the median site to 1e-6.
    End to end, differences far below a grid step flip a few 4-bit codes and
    compound over 16 blocks: 2e-3 holds for resnet18 alone
    (tests/test_torch_resnet.py); these deeper trunks measure 0.024-0.077 at
    this size and are held to 0.1 with equal argmax."""
    rels = pair.teacher_forced(POLICIES['naive_w4a4'])
    worst = max(rels, key=rels.get)
    assert rels[worst] < 1e-3, f'site {worst}: teacher-forced rel {rels[worst]:.2e}'
    assert np.median(list(rels.values())) < 1e-6
    got, want = pair.logits(POLICIES['naive_w4a4'])
    rel = _rel(got, want)
    record_property(f'{pair.arch}_w4a4_logits_rel', rel)
    assert rel <= 0.1, rel
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_resnext_serves_with_per_group_scales():
    """ResNeXt through the registry on the true-int8 serving path: live BNs
    between the integer convs, and 16 grouped 3x3 convs whose frozen input
    scales are ``[in_ch]`` vectors constant within each of the 32 groups (the
    grouped conv and its scale mapping are held to JAX layer by layer in
    ``tests/test_torch_int_kernels.py`` and block by block in
    ``test_teacher_forced_resnext_block_matches_eager_jax``; eager JAX through
    this whole trunk would cost a minute of per-op compiles).  Nothing is left dynamic, and the
    frozen W8A8 logits stay within the serving path's error budget (0.03,
    ``tests/test_serving_int8.py``) of the float logits."""
    arch = 'resnext50_32x4d'
    model, meta = build_model(arch, device='cpu')
    eng = QuantEngine(model, QuantPolicy(arch=arch, qtype='int8', qweight='int8'), meta)
    pq = eng.quantize_params(dict(model.state_dict()))
    sp = eng.prepare_serving_params(pq)
    rng = np.random.RandomState(0)
    x = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    scales = eng.freeze_serving_scales(sp, [(x, np.zeros(2, np.int32))])
    vectors = [k for k, v in scales.items() if np.ndim(v) == 1]
    assert len(vectors) == 16
    for k in vectors:
        groups = scales[k].reshape(32, -1)
        assert (groups == groups[:, :1]).all() and len(np.unique(groups[:, 0])) > 1, k
    got, aux = eng.make_forward(quantized='serving_int8', act_scales=scales)(sp, None, x)
    fp, _ = eng.make_forward(quantized=False)(pq, None, x)
    assert aux == {} and bool(torch.isfinite(got).all())
    rel = _rel(got.numpy(), fp.numpy())
    assert rel < 0.03, rel
    assert (got.argmax(-1) == fp.argmax(-1)).all()


RESNEXT_BLOCKS = ('layer1.0', 'layer2.0')


@pytest.fixture(scope='module')
def resnext_blocks():
    """(pair, JAX's prepared tree, the same tree through the bridge, each of
    ``RESNEXT_BLOCKS``' float input in one dynamic serving forward of the
    port)."""
    arch = 'resnext50_32x4d'
    pair = Pair(arch, SIZE)
    w8a8 = dict(qtype='int8', qweight='int8')
    j_eng = JEngine(pair.j_model, JPolicy(arch=arch, **w8a8), pair.j_meta)
    j_sp = j_eng.prepare_serving_params(j_eng.quantize_params(pair.j_params))
    sp = state_dict_from_flax(j_sp)
    eng = QuantEngine(pair.model, QuantPolicy(arch=arch, **w8a8), pair.meta)
    seen = {}
    hooks = [pair.model.get_submodule(name).register_forward_pre_hook(
        lambda _m, args, name=name: seen.__setitem__(name, args[0].detach().clone()))
        for name in RESNEXT_BLOCKS]
    try:
        eng.make_forward(quantized='serving_int8')(sp, None, pair.x)
    finally:
        for h in hooks:
            h.remove()
    return pair, j_sp, sp, seen


@pytest.mark.parametrize('name', RESNEXT_BLOCKS, ids=['downsample', 'strided'])
def test_teacher_forced_resnext_block_matches_eager_jax(resnext_blocks, name, record_property):
    """One ResNeXt Bottleneck on the true-int8 serving path (conv1 GEMM, the
    grouped 3x3 conv with its per-group scale vector, conv3 GEMM, the
    downsample conv, four live BNs) against eager JAX (``jax.disable_jit``:
    true division, no contracted epilogue), both fed the port's own float
    block input and JAX's prepared codes.  Dynamic: the scales and abs-max of
    conv1 and the downsample conv, which see the shared input, within 1e-6
    relative; those behind a live BN, whose ``(x - mean) * inv + bias`` the
    packages round in another order, within 1e-5, the grouped conv's
    ``[in_ch]`` vector channel by channel; E|x| 1e-5, the percentile 1e-4.
    Frozen at JAX's scales: nothing recorded.  Either output within 2e-4
    relative of JAX's: equal to float32 rounding unless an ulp of a live BN
    put one activation on the other side of a rounding tie, and one flipped
    8-bit code moves the outputs behind it by a grid step (measured: 6e-5 in
    one of the two blocks, under 1e-5 in the other)."""
    pair, j_sp, sp, inputs = resnext_blocks
    block, x = pair.model.get_submodule(name), inputs[name]
    li, bi = int(name[5]) - 1, int(name[7])
    params = {k[len(name) + 1:]: v for k, v in sp.items() if k.startswith(name + '.')}
    shared = {s.id for s in (block.conv1.site, block.downsample[0].site)}

    def both(act_scales):
        ctx = ServingInt8Context(act_scales=act_scales_from_jax(act_scales), calibrate=True)
        got = torch.func.functional_call(block, params, (x, ctx))
        j_ctx = JServingInt8Context(act_scales=act_scales, calibrate=True)
        with jax.disable_jit():
            want = JBottleneck(pair.j_model.stage_specs[li][bi]).apply(
                {'params': j_sp[f'layer{li + 1}_{bi}']},
                jnp.asarray(x.permute(0, 2, 3, 1).numpy()), j_ctx)
        rel = _rel(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
        return rel, ctx.recorded, j_ctx.recorded

    rel, rec, j_rec = both({})
    assert set(rec) == set(j_rec)
    frozen = {k: v for k, v in j_rec.items() if '/' not in k}
    assert len(frozen) == 4
    vectors = [k for k, v in frozen.items() if np.ndim(v) == 1]
    assert vectors == [block.conv2.site.id]
    groups = np.asarray(rec[vectors[0]]).reshape(32, -1)
    assert (groups == groups[:, :1]).all() and len(np.unique(groups[:, 0])) > 1
    for k, v in j_rec.items():
        if k.endswith('/pq'):
            rtol = 1e-4
        elif k.endswith('/b'):
            rtol = 1e-5
        else:
            rtol = 1e-6 if k.split('/')[0] in shared else 1e-5
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(v), rtol=rtol, atol=0, err_msg=k)
    record_property(f'resnext_{name}_dynamic_rel', rel)
    assert rel <= 2e-4, rel
    rel_f, rec_f, j_rec_f = both(frozen)
    assert rec_f == {} and j_rec_f == {}
    record_property(f'resnext_{name}_frozen_rel', rel_f)
    assert rel_f <= 2e-4, rel_f


@pytest.mark.parametrize('arch', DEEP)
def test_deep_variants_site_tables_equal_jax(arch):
    j_model, j_meta = j_build_model(arch)
    model = build_resnet(arch, fold_bn=j_meta.fold_bn)   # built, never initialised
    want = site_table(j_discover_sites(j_model, (1, SIZE, SIZE, 3)), nhwc=True)
    got = site_table(discover_sites(model, (1, 3, SIZE, SIZE)), nhwc=False)
    assert got == want
    assert (arch in _FOLDED) == j_meta.fold_bn


def test_registry_lists_what_it_builds():
    """The whole zoo is registered (the 15 architectures beyond the ResNet
    family and MobileNet-v2 are held to JAX in ``tests/test_torch_zoo_*.py``);
    an unknown arch raises naming every registered one."""
    archs = available_archs()
    assert set(SMALL + DEEP + ('resnet18', 'resnet50', 'mobilenet_v2')) < set(archs)
    assert len(archs) == 25
    with pytest.raises(ValueError, match="unknown arch 'densenet100'") as err:
        build_model('densenet100', device='cpu')
    assert all(a in str(err.value) for a in archs)
    with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
        build_model('resnet18', dtype='float16', device='cpu')
