"""The routes of the port's int8 GEMM, int8 conv and int4 GEMM kernels, and
the plain versions at the routes' shapes against the JAX package.

Each kernel has hand-written routes, chosen by shape: the int8 GEMM takes the
TMA + ``wgmma`` pipeline where TMA can describe its operands (K % 16 == 0,
aligned bases) and the ``mma.sync`` block product otherwise; the conv takes
the direct depthwise kernel for groups == in_ch == out_ch, the TMA im2col +
``wgmma`` kernel where TMA's im2col mode can describe the image (one group,
C a multiple of 64, aligned bases) and the ``mma.sync`` implicit GEMM
otherwise; the int4 GEMM takes ``wgmma`` where TMA can describe every operand
(packed A, or unpacked A with K % 16 == 0) and ``mma.sync`` otherwise.  The
route functions are pure Python and are held here to the serving site tables
of ResNet-50 (plain, packed, with the space-to-depth stem) and MobileNet-v2
(recorded at 64x64 on the ``meta`` device, then scaled to 224x224).  On the
CPU the wrappers run the plain versions, so the depthwise conv and the new
routes' conv shapes are held to eager JAX (no ``jit``: XLA would contract the
epilogue) bit for bit in float32.  The ``cuda`` tests hold every route of the
three kernels against their plain versions on the card and skip without one.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.ops.kernels.int_conv import int8_conv as j_int8_conv
from cnn_quantization_tpu.ops.kernels.int_conv import prepare_int8_weights as j_prepare
from cnn_quantization_tpu.ops.kernels.int_matmul import quantize_sym_int8 as j_quantize

from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear
from cnn_quantization_tpu_torch.ops.kernels import int4_matmul as i4
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils import counters
from cnn_quantization_tpu_torch.utils.profiling import device_ms_by_class


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
    (64, 64, 64, 'depthwise'),                                       # depthwise before im2col
    (64, 64, 1, 'im2col_wgmma'), (512, 512, 1, 'im2col_wgmma'),      # ResNet's 3x3 convs
    (1024, 2048, 1, 'im2col_wgmma'),                                 # a strided 1x1 downsample
    (96, 96, 1, 'implicit_gemm'), (32, 64, 1, 'implicit_gemm'),      # C no multiple of 64
    (128, 128, 32, 'implicit_gemm'),                                 # ResNeXt, Cg = 4
    (128, 256, 2, 'implicit_gemm'),                                  # two groups of 64
    (32, 64, 32, 'implicit_gemm'),                                   # depthwise with a multiplier
    (12, 64, 1, 'implicit_gemm'),                                    # the space-to-depth stem
])
def test_conv_route_rule(c, o, groups, route):
    assert ic.conv_route(c, o, groups, kernel=(3, 3), strides=(2, 2), padding=(1, 1)) == route


@pytest.mark.parametrize('kernel,strides,padding,aligned,route', [
    ((1, 1), (2, 2), (0, 0), True, 'im2col_wgmma'),
    ((7, 7), (8, 8), (3, 3), True, 'im2col_wgmma'),        # the widest stride TMA traverses
    ((32, 1), (1, 1), (32, 0), True, 'im2col_wgmma'),
    ((3, 3), (9, 9), (1, 1), True, 'implicit_gemm'),       # stride past 8
    ((33, 3), (1, 1), (1, 1), True, 'implicit_gemm'),      # filter past the corners' range
    ((3, 3), (1, 1), (1, 33), True, 'implicit_gemm'),
    ((3, 3), (1, 1), (1, 1), False, 'implicit_gemm'),      # a misaligned base
])
def test_conv_route_rule_tma_limits(kernel, strides, padding, aligned, route):
    assert ic.conv_route(256, 256, 1, kernel=kernel, strides=strides, padding=padding,
                         aligned=aligned) == route


@pytest.mark.parametrize('k,a_packed,aligned,route', [
    (64, False, True, 'wgmma'), (16, False, True, 'wgmma'), (512, False, True, 'wgmma'),
    (256, True, True, 'wgmma'), (2048, True, True, 'wgmma'),
    (24, False, True, 'mma_sync'), (70, False, True, 'mma_sync'),
    (128, True, True, 'mma_sync'),                            # not whole packing groups
    (256, True, False, 'mma_sync'), (64, False, False, 'mma_sync'),
])
def test_int4_route_rule(k, a_packed, aligned, route):
    assert i4.int4_route(k, a_packed, aligned) == route


def serving_site_table(arch, *, size=64, to=224, batch=128, packed=False, s2d_stem=False):
    """Every integer kernel launch of one serving forward of ``arch`` at ``to``
    x ``to``: input shapes recorded at ``size`` on the ``meta`` device and
    scaled, then each module routed as the serving path routes it (a 1x1
    stride-1 unpadded ungrouped conv and every linear is a GEMM, the in_ch == 3
    stem a float conv, or with ``s2d_stem`` an int8 conv of 12 channels and a
    4x4 filter, every other conv the int8 conv; with ``packed`` conv1, conv3
    and the downsample conv of every ResNet block an int4 GEMM, fed packed
    codes except at stage 1 block 0 and at conv3).  Returns ([(M, K, N, gemm
    route)], [(input NCHW, out, groups, conv route)], [(M, K, A packed, int4
    route)])."""
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
    gemms, convs, int4 = [], [], []
    for name, m in model.named_modules():
        if isinstance(m, QLinear):
            k, n = m.weight.shape[1], m.weight.shape[0]
            gemms.append((batch, k, n, im.gemm_route(k)))
        elif isinstance(m, QConv) and m.in_ch == 3:
            if s2d_stem:
                convs.append(((batch, 12, to // 2 + 3, to // 2 + 3), m.features, 1,
                              ic.conv_route(12, m.features, 1, kernel=(4, 4))))
        elif isinstance(m, QConv):
            _, c, h, w = shapes[name]
            h, w = h * to // size, w * to // size
            kernel = tuple(m.weight.shape[2:])
            if packed and name.startswith('layer') \
                    and name.endswith(('.conv1', '.conv3', '.downsample.0')):
                a_packed = not name.startswith('layer1.0.') and not name.endswith('.conv3')
                ho, wo = (h - 1) // m.strides[0] + 1, (w - 1) // m.strides[1] + 1
                int4.append((batch * ho * wo, c, a_packed, i4.int4_route(c, a_packed)))
            elif (kernel, m.strides, m.padding, m.groups) == ((1, 1), (1, 1), (0, 0), 1):
                gemms.append((batch * h * w, c, m.features, im.gemm_route(c)))
            else:
                convs.append(((batch, c, h, w), m.features, m.groups,
                              ic.conv_route(c, m.features, m.groups, kernel=kernel,
                                            strides=m.strides, padding=m.padding)))
    return gemms, convs, int4


@pytest.mark.parametrize('arch,gemm_routes,conv_routes', [
    ('resnet50', {'wgmma': 34}, {'im2col_wgmma': 19}),
    ('mobilenet_v2', {'wgmma': 33, 'mma_sync': 2}, {'depthwise': 17}),
])
def test_serving_site_table_routes(arch, gemm_routes, conv_routes):
    gemms, convs, _ = serving_site_table(arch)
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
    if arch == 'resnet50':
        # every 3x3 conv (C = 64 ... 512) and the three strided downsamples
        assert ((128, 64, 56, 56), 64, 1, 'im2col_wgmma') in convs
        assert ((128, 512, 7, 7), 512, 1, 'im2col_wgmma') in convs
        assert ((128, 1024, 14, 14), 2048, 1, 'im2col_wgmma') in convs


@pytest.mark.parametrize('variant,gemm_routes,conv_routes,int4_routes', [
    ('packed', {'wgmma': 1}, {'im2col_wgmma': 16}, {'wgmma': 36}),
    ('s2d_stem', {'wgmma': 34}, {'im2col_wgmma': 19, 'implicit_gemm': 1}, {}),
])
def test_resnet50_serving_variants_route_table(variant, gemm_routes, conv_routes, int4_routes):
    """The packed forward: 36 int4 GEMMs on ``wgmma`` (packed A where the
    block input arrives packed, K = 256 ... 2048; unpacked K = 64 ... 512 at
    stage 1 block 0 and at conv3), the 16 3x3 convs on the im2col route and
    the classifier on the GEMM's ``wgmma``.  With the space-to-depth stem the
    stem (12 channels) stays on the implicit GEMM."""
    gemms, convs, int4 = serving_site_table('resnet50', packed=variant == 'packed',
                                            s2d_stem=variant == 's2d_stem')
    assert Counter(g[3] for g in gemms) == gemm_routes
    assert Counter(c[3] for c in convs) == conv_routes
    assert Counter(i[3] for i in int4) == int4_routes
    if variant == 'packed':
        assert (401408, 64, False, 'wgmma') in int4           # stage 1 block 0 conv1
        assert (401408, 256, True, 'wgmma') in int4           # stage 1 conv1, packed A
        assert (6272, 2048, True, 'wgmma') in int4            # stage 4 conv1
        assert sum(i[2] for i in int4) == 18                  # conv1 and downsample past 1.0
    else:
        assert ((128, 12, 115, 115), 64, 1, 'implicit_gemm') in convs


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


@pytest.mark.parametrize('n,h,w,c,o,k,stride,pad,relu', [
    (2, 13, 11, 64, 64, 3, 2, 1, True),      # stride 2 at C = 64, odd H and W, ragged M
    (2, 14, 14, 128, 64, 1, 2, 0, False),    # a strided 1x1 downsample
    (1, 9, 7, 128, 96, 3, 1, 1, True),       # 128-byte K blocks, M = 63 < one tile
])
def test_im2col_route_shapes_equal_eager_jax(n, h, w, c, o, k, stride, pad, relu):
    """``int8_conv`` at shapes the im2col route takes (its plain version here)
    against eager JAX's ``int8_conv``: float32 outputs bit for bit, and the
    integer sums exact."""
    rng = np.random.RandomState(21)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(k, k, c, o) * 0.1).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    kw = dict(strides=(stride, stride), padding=(pad, pad), fuse_relu=relu)
    with jax.disable_jit():
        j_codes, j_scale = j_prepare(jnp.asarray(wt))
        want = np.asarray(j_int8_conv(jnp.asarray(x), j_codes, j_scale, jnp.asarray(bias), **kw))
        x_q, _ = j_quantize(jnp.asarray(x))
        acc = np.asarray(jax.lax.conv_general_dilated(
            x_q, j_codes, (stride, stride), ((pad, pad), (pad, pad)),
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'), preferred_element_type=jnp.int32))
    w_codes, w_scale = ic.prepare_int8_weights(torch.from_numpy(wt).permute(3, 2, 0, 1))
    assert ic.conv_route(c, o, 1, kernel=(k, k), strides=(stride, stride),
                         padding=(pad, pad)) == 'im2col_wgmma'
    got = ic.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), w_codes, w_scale,
                       torch.from_numpy(bias), **kw).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == acc.shape[:3] + (o,)
    np.testing.assert_array_equal(got, want)
    t_acc = ic.int_conv_exact(torch.from_numpy(np.array(x_q)).permute(0, 3, 1, 2), w_codes,
                              (stride, stride), (pad, pad), 1)
    np.testing.assert_array_equal(t_acc.permute(0, 2, 3, 1).numpy(), acc)


@pytest.mark.parametrize('kernel,cls', [
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::Tile<64>, cnnq::wg::DenseA, '
     'cnnq::wg::DequantOut<float> >(CUtensorMap_st, CUtensorMap_st)', 'int8_gemm'),
    ('void cnnq::int8_mma_kernel<(anonymous namespace)::DenseA, '
     'cnnq::DequantEpilogue<float> >(...)', 'int8_gemm'),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::ConvRing<64, 64>, cnnq::wg::Im2colA, '
     'cnnq::wg::DequantOut<__nv_bfloat16> >(...)', 'int8_conv'),
    ('void cnnq::int8_mma_kernel<(anonymous namespace)::ConvA, cnnq::DequantEpilogue<float> >',
     'int8_conv'),
    ('void (anonymous namespace)::int8_depthwise_kernel<float>(...)', 'int8_conv'),
    ('void cnnq::wg::wgmma_kernel<(anonymous namespace)::Int4Ring<64>, cnnq::wg::DenseA, '
     '(anonymous namespace)::Int4WgEpilogue<3, true> >(...)', 'int4_gemm'),
    ('void cnnq::wg::wgmma_kernel<(anonymous namespace)::Int4Ring<128>, cnnq::wg::PackedA, '
     '(anonymous namespace)::Int4WgEpilogue<2, false> >(...)', 'int4_gemm'),
    ('void cnnq::int8_mma_kernel<(anonymous namespace)::Int4A, '
     '(anonymous namespace)::Int4Epilogue<3, true> >', 'int4_gemm'),
])
def test_kernel_classes_name_every_route(kernel, cls):
    """The profiler's kernel classes tell the routes' kernels apart by the
    loader and epilogue in their names: the int4 GEMM's wgmma kernel loads
    A as ``DenseA`` too, and must not count as the int8 GEMM."""
    by_class = device_ms_by_class({kernel: 1000.0})
    assert by_class[cls] == 1.0 and sum(by_class.values()) == 1.0


def test_route_counters_stay_zero_on_the_cpu():
    """On the CPU the wrappers run the plain versions and count no launch on
    any route."""
    before = counters.snapshot()
    a = torch.zeros(4, 16, dtype=torch.int8)
    im.int8_matmul_dequant(a, torch.zeros(16, 3, dtype=torch.int8), torch.ones(3))
    x = torch.zeros(1, 8, 5, 5, dtype=torch.int8)
    ic.int8_conv_dequant(x, torch.zeros(8, 1, 3, 3, dtype=torch.int8), torch.ones(8),
                         padding=(1, 1), groups=8)
    x = torch.zeros(1, 64, 5, 5, dtype=torch.int8)
    ic.int8_conv_dequant(x, torch.zeros(64, 64, 3, 3, dtype=torch.int8), torch.ones(64),
                         padding=(1, 1))
    i4.int4_matmul(torch.zeros(4, 128, dtype=torch.int8), torch.zeros(256, 256, dtype=torch.int8),
                   torch.ones(256), a_packed=True)
    assert counters.since(before) == {}




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


@pytest.mark.cuda
def test_im2col_route_matches_plain_on_card():
    """The TMA im2col route and the implicit GEMM at the same shapes, bit for
    bit against the plain version: C = 64 (64-byte K blocks) and 128, stride 2
    with odd H and W, a strided 1x1, a 5x5 filter."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(1)
    cl = torch.channels_last

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).cuda()

    for shape, o, k, s, p in (((3, 64, 13, 11), 64, 3, 2, 1), ((2, 128, 9, 7), 96, 3, 1, 1),
                              ((2, 256, 14, 14), 512, 1, 2, 0), ((2, 192, 17, 15), 256, 5, 2, 2)):
        x = codes(shape).contiguous(memory_format=cl)
        w = codes((o, shape[1], k, k)).contiguous(memory_format=cl)
        alpha, bias = torch.rand(o, generator=g).cuda() * 1e-3, torch.randn(o, generator=g).cuda()
        assert ic.conv_route(shape[1], o, 1, kernel=(k, k), strides=(s, s),
                             padding=(p, p)) == 'im2col_wgmma'
        for dt in (torch.float32, torch.bfloat16):
            want = ic.int8_conv_dequant_plain(x, w, alpha, bias, strides=(s, s), padding=(p, p),
                                              fuse_relu=True, out_dtype=dt)
            for route in ('im2col_wgmma', 'implicit_gemm'):
                got = ic.launch(x, w, alpha, bias, (s, s), (p, p), 1, True, dt, route)
                torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_int4_routes_match_plain_on_card():
    """Both int4 GEMM routes in every output mode, packed and unpacked A, with
    and without a residual, ragged M, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(2)

    def codes(shape):
        return torch.randint(-7, 8, shape, generator=g, dtype=torch.int8).cuda()

    scale = lambda v: torch.full((), v, device='cuda')  # noqa: E731
    for m, k, n in ((300, 256, 256), (13, 512, 512), (70, 64, 256), (1000, 256, 64)):
        a, bt = codes((m, k)), codes((n, k))
        alpha = (torch.rand(n, generator=g) * 1e-2).cuda()
        beta = torch.randn(n, generator=g).cuda()
        res = i4.pack_int4(codes((m, n))) if n % 256 == 0 else None
        for a_packed in (False, True):
            a_in = i4.pack_int4(a) if a_packed else a
            for mode in ('f32', 'bf16', 'int8', 'packed'):
                if mode == 'packed' and res is None:
                    continue
                want = i4.int4_matmul_plain(a_in, bt.t(), alpha, beta, residual=res,
                                            res_scale=scale(0.11), out_scale=scale(0.07),
                                            a_packed=a_packed, fuse_relu=True, out_mode=mode,
                                            out_qmax=7.0)
                for route in ('wgmma', 'mma_sync'):
                    got = i4.launch(a_in, bt.t(), alpha, beta, res, scale(0.11), scale(0.07),
                                    a_packed, True, mode, 7.0, torch.float32, route=route)
                    assert torch.equal(got, want), (m, k, n, a_packed, mode, route)
