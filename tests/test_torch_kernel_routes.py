"""The routes of the port's int8 GEMM and int8 conv kernels, and the
depthwise conv against the JAX package.

Each kernel has two hand-written routes, chosen by shape: the GEMM takes the
TMA + ``wgmma`` pipeline where TMA can describe its operands (K % 16 == 0,
aligned bases) and the ``mma.sync`` block product otherwise; the conv takes
the direct depthwise kernel for groups == in_ch == out_ch and the implicit
GEMM otherwise.  The route functions are pure Python and are held here to
the serving site tables of ResNet-50 and MobileNet-v2 (recorded at 64x64 on
the ``meta`` device, then scaled to 224x224).  On the CPU the wrappers run
the plain versions, so the depthwise conv is held to eager JAX (no ``jit``:
XLA would contract the epilogue) bit for bit in float32.  The ``cuda`` test
holds both routes of both kernels against their plain versions on the card
and skips without one.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.ops.kernels.int_conv import int8_conv as j_int8_conv
from cnn_quantization_tpu.ops.kernels.int_conv import prepare_int8_weights as j_prepare

from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """PyTorch's plain int32 depthwise conv on the CPU stalls for minutes
    under several test workers (OpenMP barriers on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('k,aligned,route', [
    (64, True, 'wgmma'), (16, True, 'wgmma'), (272, True, 'wgmma'), (2048, True, 'wgmma'),
    (24, True, 'mma_sync'), (70, True, 'mma_sync'), (1000, True, 'mma_sync'),
    (64, False, 'mma_sync'),
])
def test_gemm_route_rule(k, aligned, route):
    assert im.gemm_route(k, aligned) == route


@pytest.mark.parametrize('c,o,groups,route', [
    (144, 144, 144, 'depthwise'), (96, 96, 96, 'depthwise'), (1, 1, 1, 'depthwise'),
    (64, 64, 1, 'implicit_gemm'), (128, 128, 32, 'implicit_gemm'),   # ResNeXt, Cg = 4
    (32, 64, 32, 'implicit_gemm'),                                   # depthwise with a multiplier
    (12, 64, 1, 'implicit_gemm'),                                    # the space-to-depth stem
])
def test_conv_route_rule(c, o, groups, route):
    assert ic.conv_route(c, o, groups) == route


def serving_site_table(arch, *, size=64, to=224, batch=128):
    """Every int8 GEMM and int8 conv of one serving forward of ``arch`` at
    ``to`` x ``to``: input shapes recorded at ``size`` on the ``meta`` device
    and scaled, then each module routed as the serving path routes it (a 1x1
    stride-1 unpadded ungrouped conv and every linear is a GEMM, the in_ch == 3
    stem a float conv, every other conv the int8 conv).  Returns
    ([(M, K, N, gemm route)], [(input NCHW, out, groups, conv route)])."""
    model, _ = build_model(arch, device='cpu')
    shapes = {}

    def record(name):
        def hook(module, args):
            shapes[name] = tuple(args[0].shape)
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in model.named_modules() if isinstance(m, (QConv, QLinear))]
    try:
        discover_sites(model, (1, 3, size, size))
    finally:
        for h in hooks:
            h.remove()
    gemms, convs = [], []
    for name, m in model.named_modules():
        if isinstance(m, QLinear):
            k, n = m.weight.shape[1], m.weight.shape[0]
            gemms.append((batch, k, n, im.gemm_route(k)))
        elif isinstance(m, QConv) and m.in_ch != 3:
            _, c, h, w = shapes[name]
            h, w = h * to // size, w * to // size
            if (tuple(m.weight.shape[2:]), m.strides, m.padding, m.groups) \
                    == ((1, 1), (1, 1), (0, 0), 1):
                gemms.append((batch * h * w, c, m.features, im.gemm_route(c)))
            else:
                convs.append(((batch, c, h, w), m.features, m.groups,
                              ic.conv_route(c, m.features, m.groups)))
    return gemms, convs


@pytest.mark.parametrize('arch,gemm_routes,conv_routes', [
    ('resnet50', {'wgmma': 34}, {'implicit_gemm': 19}),
    ('mobilenet_v2', {'wgmma': 33, 'mma_sync': 2}, {'depthwise': 17}),
])
def test_serving_site_table_routes(arch, gemm_routes, conv_routes):
    gemms, convs = serving_site_table(arch)
    assert Counter(g[3] for g in gemms) == gemm_routes
    assert Counter(c[3] for c in convs) == conv_routes
    # the scaled table holds the shapes the card runs at 224x224, batch 128
    if arch == 'resnet50':
        assert (401408, 256, 64, 'wgmma') in gemms
        assert (6272, 512, 2048, 'wgmma') in gemms
        assert (128, 2048, 1000, 'wgmma') in gemms
    else:
        assert [g[:3] for g in gemms if g[3] == 'mma_sync'] == [(401408, 24, 144)] * 2
        assert ((128, 144, 56, 56), 144, 144, 'depthwise') in convs
        assert ((128, 96, 112, 112), 96, 96, 'depthwise') in convs


def _depthwise_case(rng, c, h, w, k):
    """NHWC activations whose channels differ in scale by up to 10^3, an HWIO
    depthwise weight, a bias, and the per-channel frozen activation scales."""
    mult = np.logspace(-1, 2, c).astype(np.float32)
    x = rng.randn(2, h, w, c).astype(np.float32) * mult
    wt = rng.randn(k, k, 1, c).astype(np.float32) * 0.1
    bias = rng.randn(c).astype(np.float32)
    scale = (np.abs(x).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
    return x, wt, bias, scale


@pytest.mark.parametrize('stride,pad,k,relu', [(1, 1, 3, False), (2, 1, 3, True), (1, 2, 5, True)])
def test_depthwise_int8_conv_equals_eager_jax(stride, pad, k, relu):
    """Depthwise ``int8_conv`` with a per-channel activation scale, C = 48,
    odd spatial sizes: float32 outputs equal to eager JAX's bit for bit."""
    rng = np.random.RandomState(11)
    c = 48
    x, wt, bias, scale = _depthwise_case(rng, c, 11, 13, k)
    kw = dict(strides=(stride, stride), padding=(pad, pad), groups=c, fuse_relu=relu)
    with jax.disable_jit():
        j_codes, j_scale = j_prepare(jnp.asarray(wt))
        want = np.asarray(j_int8_conv(jnp.asarray(x), j_codes, j_scale, jnp.asarray(bias),
                                      act_scale=jnp.asarray(scale), **kw))
    w_codes, w_scale = ic.prepare_int8_weights(torch.from_numpy(wt).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(w_codes.permute(2, 3, 1, 0).numpy(), np.asarray(j_codes))
    assert ic.conv_route(c, w_codes.shape[0], c) == 'depthwise'
    got = ic.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), w_codes, w_scale,
                       torch.from_numpy(bias), act_scale=torch.from_numpy(scale), **kw)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if relu:
        assert got.min() >= 0


def test_route_counters_stay_zero_on_the_cpu():
    """On the CPU the wrappers run the plain versions and count no launch on
    any route."""
    a = torch.zeros(4, 16, dtype=torch.int8)
    im.int8_matmul_dequant(a, torch.zeros(16, 3, dtype=torch.int8), torch.ones(3))
    x = torch.zeros(1, 8, 5, 5, dtype=torch.int8)
    ic.int8_conv_dequant(x, torch.zeros(8, 1, 3, 3, dtype=torch.int8), torch.ones(8),
                         padding=(1, 1), groups=8)
    assert (im.int8_matmul_dequant.launches_wgmma, im.int8_matmul_dequant.launches_mma_sync,
            ic.int8_conv_dequant.launches_depthwise,
            ic.int8_conv_dequant.launches_implicit_gemm) == (0, 0, 0, 0)


@pytest.mark.cuda
def test_both_routes_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(0)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).cuda()

    for m, k, n in ((3001, 272, 1000), (300, 24, 50), (128, 2048, 1000), (77, 16, 300)):
        a, bt = codes((m, k)), codes((n, k))
        alpha, beta = torch.rand(n, generator=g).cuda(), torch.randn(n, generator=g).cuda()
        for dt in (torch.float32, torch.bfloat16):
            got = im.int8_matmul_dequant(a, bt.t(), alpha, beta, fuse_relu=True, out_dtype=dt)
            want = im.int8_matmul_dequant_plain(a, bt.t(), alpha, beta, fuse_relu=True,
                                                out_dtype=dt)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    for shape, s in (((2, 40, 17, 13), 2), ((3, 48, 11, 13), 1), ((2, 144, 56, 56), 1)):
        c = shape[1]
        x = codes(shape).contiguous(memory_format=torch.channels_last)
        w = codes((c, 1, 3, 3))
        alpha, bias = torch.rand(c, generator=g).cuda(), torch.randn(c, generator=g).cuda()
        kw = dict(strides=(s, s), padding=(1, 1), groups=c)
        got = ic.int8_conv_dequant(x, w, alpha, bias, **kw)
        want = ic.int8_conv_dequant_plain(x, w, alpha, bias, **kw)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
