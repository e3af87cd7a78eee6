"""The port's int8 GEMM and int8 conv (plain versions on the CPU) against the
JAX package, on the same numpy-seeded inputs.

The integer sums must be exact.  The float32 outputs may differ from JAX's by
one float32 ulp of the product ``acc * alpha`` (XLA may contract the
epilogue's multiply and add into one rounding; the port rounds each), bf16
outputs by one bf16 ulp.  The JAX GEMM runs its Pallas kernel in interpret
mode, the JAX conv is XLA's int8 convolution, as ``tests/test_int_conv.py``
runs them.  The ``cuda`` test holds both CUDA kernels against their plain
versions on the card and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax

from cnn_quantization_tpu.engine.engine import s2d_stem_input as j_s2d_input
from cnn_quantization_tpu.engine.engine import s2d_stem_kernel as j_s2d_kernel
from cnn_quantization_tpu.ops.kernels.int_conv import int8_conv as j_int8_conv
from cnn_quantization_tpu.ops.kernels.int_conv import int8_conv_im2col as j_im2col
from cnn_quantization_tpu.ops.kernels.int_conv import prepare_int8_weights as j_prepare
from cnn_quantization_tpu.ops.kernels.int_matmul import int8_matmul_dequant as j_matmul
from cnn_quantization_tpu.ops.kernels.int_matmul import quantize_sym_int8 as j_quantize

from cnn_quantization_tpu_torch.engine.context import percentile_rows
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils import counters


def _nchw(x_nhwc):
    """NHWC numpy -> NCHW channels_last torch (the port's activation layout)."""
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _oihw(w_hwio):
    return torch.from_numpy(np.array(w_hwio)).permute(3, 2, 0, 1)


def _assert_within_one_ulp(got, want, scale_of, eps=2.0 ** -23):
    """|got - want| <= one ulp (``eps`` relative) of ``scale_of``, the largest
    intermediate of the epilogue at each element."""
    tol = eps * np.maximum(np.abs(scale_of), np.abs(want)) + 1e-30
    bad = np.abs(got.astype(np.float64) - want.astype(np.float64)) > tol
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


# ---------------------------------------------------------------- the GEMM

@pytest.mark.parametrize('m,k,n,relu,dtype', [
    (100, 70, 50, False, 'float32'),      # ragged M, K and N
    (257, 64, 33, True, 'float32'),       # one row past a tile, fused ReLU
    (8, 16, 1000, False, 'float32'),      # the classifier's ragged N
    (64, 48, 24, True, 'bfloat16'),
])
def test_int8_gemm_matches_pallas_interpret(m, k, n, relu, dtype):
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    alpha = (rng.rand(n).astype(np.float32) + 0.1) * 1e-3
    beta = rng.randn(n).astype(np.float32)
    acc = a.astype(np.int32) @ b.astype(np.int32)
    ta, tbt = torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))
    # the exact integer product, from the layout the serving path hands over
    # (b as the transposed view of an [N, K] weight)
    np.testing.assert_array_equal(im.int_matmul_exact(ta, tbt.t()).numpy(), acc)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = im.int8_matmul_dequant(ta, tbt.t(), torch.from_numpy(alpha), torch.from_numpy(beta),
                                 fuse_relu=relu, out_dtype=tdt)
    want = np.asarray(j_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha),
                               jnp.asarray(beta), fuse_relu=relu, out_dtype=jdt,
                               interpret=True).astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (m, n)
    if relu:
        assert float(got.float().min()) >= 0
    eps = 2.0 ** -23 if dtype == 'float32' else 2.0 ** -8
    _assert_within_one_ulp(got.float().numpy(), want, acc * alpha, eps)


def test_int8_gemm_beta_none_and_scalar_alpha():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randint(-127, 128, (9, 20)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (20, 7)).astype(np.int8))
    got = im.int8_matmul_dequant(a, b, 0.5)
    want = (a.int() @ b.int()).float() * 0.5
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize('axis', [None, 0, 1])
@pytest.mark.parametrize('bits', [8, 4])
def test_quantize_sym_int8_equals_jax(axis, bits):
    rng = np.random.RandomState(2)
    x = rng.randn(64, 32).astype(np.float32)
    j_codes, j_scale = j_quantize(x, axis=axis, bits=bits)
    codes, scale = im.quantize_sym_int8(torch.from_numpy(x), axis=axis, bits=bits)
    assert codes.dtype == torch.int8
    assert int(codes.abs().max()) == 2 ** (bits - 1) - 1
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), rtol=1e-6)


def test_gemm_wrapper_contract():
    """On the CPU the wrapper runs the plain version and counts no launch;
    the launch itself takes CUDA tensors only, and int8 operands only."""
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 3, dtype=torch.int8)
    before = counters.snapshot()
    im.int8_matmul_dequant(a, b, torch.ones(3), torch.zeros(3))
    assert counters.since(before) == {}
    with pytest.raises(ValueError, match='CUDA'):
        im.launch(a, b, torch.ones(3), None, False, torch.float32)
    with pytest.raises(TypeError, match='int8'):
        im.int8_matmul_dequant(a.float(), b, torch.ones(3))
    with pytest.raises(ValueError, match='cannot multiply'):
        im.int8_matmul_dequant(a, b.t(), torch.ones(3))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        im.int8_matmul_dequant(a, b, torch.ones(3), out_dtype=torch.float16)


# ---------------------------------------------------------------- the conv

def _conv_case(rng, n, hw, c, feat, kh, groups, scale_mult=None):
    x = rng.randn(n, hw, hw, c).astype(np.float32)
    if scale_mult is not None:
        x *= scale_mult
    w = rng.randn(kh, kh, c // groups, feat).astype(np.float32) * 0.1
    bias = rng.randn(feat).astype(np.float32)
    return x, w, bias


def _both(x, w, bias, *, stride, pad, groups=1, act_scale=None, act_bits=8, relu=False,
          codes_in=False):
    """The serving conv in both packages on the same float (or int8) input.
    Returns (port NHWC float32, JAX float32, the dequantized-float reference's
    ingredients)."""
    j_codes, j_scale = j_prepare(jnp.asarray(w))
    w_codes, w_scale = ic.prepare_int8_weights(_oihw(w))
    np.testing.assert_array_equal(w_codes.permute(2, 3, 1, 0).numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(w_scale.numpy(), np.asarray(j_scale), rtol=1e-6)
    kw = dict(strides=(stride, stride), padding=(pad, pad), groups=groups,
              act_bits=act_bits, fuse_relu=relu)
    j_as = None if act_scale is None else jnp.asarray(act_scale)
    t_as = None if act_scale is None else torch.as_tensor(act_scale)
    want = np.asarray(j_int8_conv(jnp.asarray(x), j_codes, j_scale, jnp.asarray(bias),
                                  act_scale=j_as, **kw))
    got = ic.int8_conv(_nchw(x), w_codes, w_scale, torch.from_numpy(bias), act_scale=t_as, **kw)
    assert got.dtype == torch.float32
    return _nhwc(got), want


@pytest.mark.parametrize('kh,stride,pad', [(1, 1, 0), (3, 1, 1), (3, 2, 1), (1, 2, 0)])
def test_int8_conv_matches_jax(kh, stride, pad):
    rng = np.random.RandomState(3)
    x, w, bias = _conv_case(rng, 2, 14, 16, 32, kh, 1)
    got, want = _both(x, w, bias, stride=stride, pad=pad)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # and the integer sums themselves are exact
    x_q, _ = j_quantize(jnp.asarray(x))
    w_q, _ = j_prepare(jnp.asarray(w))
    acc = np.asarray(lax.conv_general_dilated(
        x_q, w_q, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'), preferred_element_type=jnp.int32))
    t_acc = ic.int_conv_exact(_nchw(np.asarray(x_q)), _oihw(np.asarray(w_q)),
                              (stride, stride), (pad, pad), 1)
    np.testing.assert_array_equal(t_acc.permute(0, 2, 3, 1).numpy(), acc)


@pytest.mark.parametrize('c,feat,groups', [(16, 32, 4), (32, 32, 32)],
                         ids=['grouped', 'depthwise'])
def test_int8_conv_groups_match_jax(c, feat, groups):
    rng = np.random.RandomState(4)
    x, w, bias = _conv_case(rng, 2, 8, c, feat, 3, groups)
    got, want = _both(x, w, bias, stride=1, pad=1, groups=groups, relu=True)
    assert got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_conv_frozen_scalar_scale_and_narrow_grid():
    rng = np.random.RandomState(5)
    x, w, bias = _conv_case(rng, 2, 8, 8, 8, 1, 1)
    scale = float(np.abs(x).max() / 127.0)
    got, want = _both(x, w, bias, stride=1, pad=0, act_scale=np.float32(scale))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a clipping scale on the 4-bit grid saturates at +-7 in both packages
    got4, want4 = _both(x, w, bias, stride=1, pad=0, act_scale=np.float32(scale * 8),
                        act_bits=4)
    np.testing.assert_allclose(got4, want4, rtol=1e-6, atol=1e-6)
    assert np.abs(got4 - got).max() > 1e-3


@pytest.mark.parametrize('c,feat,groups', [(24, 32, 4), (16, 16, 16)],
                         ids=['per_group', 'per_channel_depthwise'])
def test_int8_conv_vector_act_scale_matches_jax(c, feat, groups):
    """An ``[in_ch]`` activation scale constant within each group maps to the
    per-output-channel epilogue scale gs[group_of(o)] in both packages."""
    rng = np.random.RandomState(8)
    per = c // groups
    mult = np.repeat(np.logspace(-1, 2, groups), per).astype(np.float32)
    x, w, bias = _conv_case(rng, 2, 10, c, feat, 3, groups, scale_mult=mult)
    gs = np.abs(x).reshape(-1, groups, per).max(axis=(0, 2)) / 127.0
    vec = np.repeat(gs, per).astype(np.float32)
    got, want = _both(x, w, bias, stride=1, pad=1, groups=groups, act_scale=vec)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='scale vector'):
        ic.int8_conv(_nchw(x), *ic.prepare_int8_weights(_oihw(w)), groups=groups,
                     padding=(1, 1), act_scale=torch.from_numpy(vec[:-1]))


def test_int8_conv_codes_input():
    """int8 input is taken as codes: ``act_scale`` is their scale and is
    required."""
    rng = np.random.RandomState(9)
    x, w, bias = _conv_case(rng, 2, 9, 16, 8, 3, 1)
    codes, scale = j_quantize(jnp.asarray(x))
    j_codes, j_scale = j_prepare(jnp.asarray(w))
    want = np.asarray(j_int8_conv(codes, j_codes, j_scale, jnp.asarray(bias),
                                  strides=(2, 2), padding=(1, 1), act_scale=scale))
    w_codes, w_scale = ic.prepare_int8_weights(_oihw(w))
    t_codes = _nchw(np.asarray(codes))
    got = ic.int8_conv(t_codes, w_codes, w_scale, torch.from_numpy(bias), strides=(2, 2),
                       padding=(1, 1), act_scale=float(scale))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='requires act_scale'):
        ic.int8_conv(t_codes, w_codes, w_scale)


def test_conv_wrapper_contract():
    x = torch.zeros(1, 4, 5, 5, dtype=torch.int8)
    w = torch.zeros(6, 4, 3, 3, dtype=torch.int8)
    before = counters.snapshot()
    out = ic.int8_conv_dequant(x, w, torch.ones(6), padding=(1, 1), out_dtype=torch.bfloat16)
    assert out.shape == (1, 6, 5, 5) and out.dtype == torch.bfloat16
    assert counters.since(before) == {}
    with pytest.raises(ValueError, match='CUDA'):
        ic.launch(x, w, torch.ones(6), None, (1, 1), (1, 1), 1, False, torch.float32)
    with pytest.raises(ValueError, match='do not fit'):
        ic.int8_conv_dequant(x, w, torch.ones(6), groups=2)
    with pytest.raises(TypeError, match='int8'):
        ic.int8_conv_dequant(x.float(), w, torch.ones(6))


@pytest.mark.parametrize('kh,stride,pad', [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0)])
def test_int8_conv_im2col_equals_int8_conv_and_matches_jax(kh, stride, pad):
    """The explicit lowering (patches in memory + the int8 GEMM) computes what
    ``int8_conv`` computes, bit for bit (the same exact sums, the same
    epilogue), and matches JAX's im2col + Pallas GEMM (interpret mode) within
    the conv tests' 1e-6."""
    rng = np.random.RandomState(6)
    x, w, bias = _conv_case(rng, 2, 9, 16, 24, kh, 1)
    w_codes, w_scale = ic.prepare_int8_weights(_oihw(w))
    kw = dict(strides=(stride, stride), padding=(pad, pad), fuse_relu=True)
    got = ic.int8_conv_im2col(_nchw(x), w_codes, w_scale, torch.from_numpy(bias), **kw)
    same = ic.int8_conv(_nchw(x), w_codes, w_scale, torch.from_numpy(bias), **kw)
    assert torch.equal(got, same)
    j_codes, j_scale = j_prepare(jnp.asarray(w))
    want = np.asarray(j_im2col(jnp.asarray(x), j_codes, j_scale, jnp.asarray(bias),
                               interpret=True, **kw))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='groups unsupported'):
        ic.int8_conv_im2col(_nchw(x)[:, :8], w_codes, w_scale)


# ------------------------------------------------- s2d stem and percentile

def test_s2d_stem_transform_equals_jax_and_the_7x7_conv():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    w = rng.randn(7, 7, 3, 8).astype(np.float32)
    wk = ic.s2d_stem_kernel(_oihw(w))
    xs = ic.s2d_stem_input(_nchw(x))
    np.testing.assert_array_equal(wk.permute(2, 3, 1, 0).numpy(), np.asarray(j_s2d_kernel(w)))
    np.testing.assert_array_equal(_nhwc(xs), np.asarray(j_s2d_input(x)))
    assert xs.permute(0, 2, 3, 1).is_contiguous()  # channels_last memory
    ref = torch.nn.functional.conv2d(_nchw(x), _oihw(w), None, 2, 3)
    got = torch.nn.functional.conv2d(xs, wk)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='even input size'):
        ic.s2d_stem_input(torch.zeros(1, 3, 63, 64))


@pytest.mark.parametrize('q', [50.0, 99.5, 99.99, 100.0])
def test_percentile_rows_equals_jnp_percentile(q):
    rng = np.random.RandomState(2)
    rows = np.abs(rng.randn(3, 4097)).astype(np.float32)
    got = percentile_rows(torch.from_numpy(rows), q).numpy()
    want = np.asarray(jnp.percentile(jnp.asarray(rows), q, axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_int8_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(0)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).cuda()

    # both GEMM routes: mma.sync (K = 70) and TMA + wgmma (ragged M, N and K)
    for m, k, n in ((300, 70, 50), (3001, 272, 1000)):
        a, bt = codes((m, k)), codes((n, k))
        alpha, beta = torch.rand(n, generator=g).cuda(), torch.randn(n, generator=g).cuda()
        got = im.int8_matmul_dequant(a, bt.t(), alpha, beta, fuse_relu=True)
        want = im.int8_matmul_dequant_plain(a, bt.t(), alpha, beta, fuse_relu=True)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    # both conv routes: implicit GEMM, and direct depthwise (C = 32; C = 40
    # with odd H and W, no multiple of 16)
    for shape, o, k, s, p, groups in (((2, 16, 14, 14), 32, 3, 2, 1, 1),
                                      ((2, 12, 35, 35), 64, 4, 1, 0, 1),
                                      ((2, 32, 15, 15), 32, 3, 1, 1, 32),
                                      ((2, 40, 17, 13), 40, 3, 2, 1, 40)):
        x = codes(shape).contiguous(memory_format=torch.channels_last)
        w = codes((o, shape[1] // groups, k, k))
        alpha, bias = torch.rand(o, generator=g).cuda(), torch.randn(o, generator=g).cuda()
        kw = dict(strides=(s, s), padding=(p, p), groups=groups)
        got = ic.int8_conv_dequant(x, w, alpha, bias, **kw)
        want = ic.int8_conv_dequant_plain(x, w, alpha, bias, **kw)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
