"""The port's int4-packed GEMM (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, on the same numpy-seeded inputs,
for every case of ``tests/test_int4_packed.py``.

Tolerances and their reasons:

  * packed bytes of ``pack_int4`` and codes of ``unpack_int4`` **equal** JAX's
    (pure bit manipulation);
  * float32 outputs within rtol 1e-6 / atol 1e-5 of JAX's (the JAX test's own
    bar: the int32 sum is exact, only the epilogue rounds, and XLA may
    contract its multiply and add into one rounding under the kernel's
    ``jit``), bfloat16 outputs within one bf16 ulp;
  * int8 codes and packed bytes: **equal** to exact integer arithmetic in
    numpy followed by separately rounded float32 operations (multiply, add,
    add, max, true division, round half to even, clip), which is what the
    CUDA kernel computes too; against JAX's kernel a code may differ by one
    step at fewer than 1e-3 of the elements (the bar of
    ``test_int4_packed.py:87-90``), for the contraction named above moves a
    value that sits on a rounding tie.

The ``cuda`` test holds the CUDA kernel against the plain version on the card
and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cnn_quantization_tpu.ops.kernels.int4_matmul import int4_matmul as j_int4_matmul
from cnn_quantization_tpu.ops.kernels.int4_matmul import pack_int4 as j_pack
from cnn_quantization_tpu.ops.kernels.int4_matmul import unpack_int4 as j_unpack

from cnn_quantization_tpu_torch.ops.kernels import int4_matmul as i4
from cnn_quantization_tpu_torch.utils import counters


def _codes(rs, shape, lo=-7, hi=7):
    return rs.randint(lo, hi + 1, shape).astype(np.int8)


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize('lo,hi', [(-7, 7), (-8, 7)], ids=['sym', 'full_nibble'])
def test_pack_unpack_bytes_equal_jax(lo, hi):
    rs = np.random.RandomState(0)
    c = _codes(rs, (3, 5, 512), lo, hi)
    packed = i4.pack_int4(torch.from_numpy(c))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (3, 5, 256)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_pack(jnp.asarray(c))))
    raw = rs.randint(-128, 128, (4, 256)).astype(np.int8)   # any byte unpacks alike
    np.testing.assert_array_equal(i4.unpack_int4(torch.from_numpy(raw)).numpy(),
                                  np.asarray(j_unpack(jnp.asarray(raw))))
    np.testing.assert_array_equal(i4.unpack_int4(packed).numpy(), c)


def test_pack_layout_group_local():
    """Byte g*128+j holds code g*256+j (low) and g*256+128+j (high)."""
    rs = np.random.RandomState(1)
    c = _codes(rs, (2, 512))
    p = i4.pack_int4(torch.from_numpy(c)).numpy()
    for g in range(2):
        for j in (0, 17, 127):
            byte = p[:, g * 128 + j].astype(np.int8)
            lo = np.left_shift(byte, 4).astype(np.int8) >> 4
            hi = byte >> 4
            np.testing.assert_array_equal(lo, c[:, g * 256 + j])
            np.testing.assert_array_equal(hi, c[:, g * 256 + 128 + j])


def test_pack_on_nchw_view_and_shape_errors():
    """The layers pack along the channel axis of an NCHW tensor through its
    NHWC view; a channel count off the group raises."""
    rs = np.random.RandomState(2)
    c = torch.from_numpy(_codes(rs, (2, 256, 3, 3))).contiguous(memory_format=torch.channels_last)
    packed = i4.pack_int4(c.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert tuple(packed.shape) == (2, 128, 3, 3)
    assert torch.equal(i4.unpack_int4(packed.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), c)
    with pytest.raises(ValueError, match='multiple of 256'):
        i4.pack_int4(torch.zeros(2, 128, dtype=torch.int8))
    with pytest.raises(ValueError, match='whole groups'):
        i4.unpack_int4(torch.zeros(2, 64, dtype=torch.int8))


# ----------------------------------------------------------------- the GEMM

def _case(seed, m, k, n, *, res=False):
    rs = np.random.RandomState(seed)
    case = dict(a=_codes(rs, (m, k)), b=_codes(rs, (k, n)),
                alpha=(rs.rand(n).astype(np.float32) + 0.05) * 1e-2,
                beta=rs.randn(n).astype(np.float32) * 0.1)
    if res:
        case['res'] = _codes(rs, (m, n))
    return case


def _exact(case, *, res_scale=None, out_scale=None, relu=False, out_mode='f32', qmax=127.0):
    """Exact integer arithmetic, then one rounded float32 operation each."""
    acc = case['a'].astype(np.int64) @ case['b'].astype(np.int64)
    v = acc.astype(np.float32) * case['alpha'] + case['beta']
    if 'res' in case:
        v = v + case['res'].astype(np.float32) * np.float32(res_scale)
    if relu:
        v = np.maximum(v, np.float32(0))
    if out_mode in ('f32', 'bf16'):
        return v
    q = 7.0 if out_mode == 'packed' else qmax
    return np.clip(np.round(v / np.float32(out_scale)), -q, q).astype(np.int8)


def _both(case, *, a_packed=False, res_scale=None, out_scale=None, relu=False, out_mode='f32',
          qmax=127.0):
    """(port, JAX) outputs; packed outputs unpacked to codes after the bytes
    were compared."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    kw = dict(res_scale=res_scale, out_scale=out_scale, a_packed=a_packed, fuse_relu=relu,
              out_mode=out_mode, out_qmax=qmax)
    got = i4.int4_matmul(i4.pack_int4(t['a']) if a_packed else t['a'], t['b'], t['alpha'],
                         t['beta'], residual=i4.pack_int4(t['res']) if 'res' in t else None, **kw)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    if out_mode == 'bf16':
        kw['out_dtype'] = jnp.bfloat16
    want = j_int4_matmul(j_pack(j['a']) if a_packed else j['a'], j['b'], j['alpha'], j['beta'],
                         residual=j_pack(j['res']) if 'res' in j else None, **kw)
    return got, want


def _assert_codes(got, want, exact, out_mode):
    """Port == exact arithmetic; JAX within one step at under 1e-3."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.int8 and got.shape == want.shape
    if out_mode == 'packed':
        assert got.shape[1] * 2 == exact.shape[1]
        got_codes = i4.unpack_int4(torch.from_numpy(got)).numpy()
        want = np.asarray(j_unpack(jnp.asarray(want)))
        np.testing.assert_array_equal(got, i4.pack_int4(torch.from_numpy(exact)).numpy())
    else:
        got_codes = got
    np.testing.assert_array_equal(got_codes, exact)
    diff = np.abs(got_codes.astype(np.int32) - want.astype(np.int32))
    assert (diff <= 1).all() and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize('a_packed', [False, True], ids=['a_int8', 'a_packed'])
def test_matmul_f32(a_packed):
    case = _case(2, 70, 512, 384)
    got, want = _both(case, a_packed=a_packed)
    assert got.dtype == torch.float32 and tuple(got.shape) == (70, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), _exact(case))


def test_matmul_residual_relu_packed_out():
    """The full serving epilogue: packed A, packed residual, ReLU, requantize,
    packed output."""
    case = _case(3, 64, 256, 256, res=True)
    kw = dict(res_scale=0.11, out_scale=0.07, relu=True, out_mode='packed')
    got, want = _both(case, a_packed=True, **kw)
    assert tuple(got.shape) == (64, 128)
    _assert_codes(got, want, _exact(case, **kw), 'packed')


def test_matmul_int8_out_mode():
    case = _case(4, 32, 256, 128)
    kw = dict(out_scale=0.01, out_mode='int8')
    got, want = _both(case, a_packed=True, **kw)
    _assert_codes(got, want, _exact(case, **kw), 'int8')
    assert int(np.abs(got.numpy()).max()) > 7   # the int8 grid, not the nibble's


def test_matmul_ragged_m_narrow_n():
    """M not a tile multiple, N = 64 below a packing group."""
    case = _case(5, 13, 256, 64)
    got, want = _both(case, a_packed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), _exact(case))


@pytest.mark.parametrize('out_mode,with_res', [
    ('f32', False), ('f32', True), ('bf16', False), ('bf16', True), ('int8', False),
    ('int8', True), ('packed', False), ('packed', True)])
def test_matmul_shallow_k_every_mode(out_mode, with_res):
    """K = 64, the stage-1 shapes the JAX kernel pairs rows for: every
    ``out_mode``, with and without a residual, on the +-7 grid."""
    case = _case(11, 64, 64, 256, res=with_res)
    kw = dict(res_scale=0.013 if with_res else None, out_scale=0.02, relu=True,
              out_mode=out_mode, qmax=7.0)
    got, want = _both(case, **kw)
    exact = _exact(case, **kw)
    if out_mode in ('int8', 'packed'):
        _assert_codes(got, want, exact, out_mode)
        return
    want = np.asarray(want.astype(jnp.float32))
    if out_mode == 'f32':
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got.numpy(), exact)
    else:
        assert got.dtype == torch.bfloat16
        g = got.float().numpy()
        assert (np.abs(g - want) <= np.abs(want) * 2.0 ** -7 + 1e-30).all()   # one bf16 ulp
        np.testing.assert_array_equal(g, torch.from_numpy(exact).bfloat16().float().numpy())


@pytest.mark.parametrize('m,k,n,a_packed,res,out_mode', [
    (130, 256, 256, True, True, 'packed'),   # one packing group a tile, ragged M, residual
    (200, 512, 64, True, False, 'int8'),     # N = 64 -> int8 codes, two packed groups of K
    (70, 64, 512, False, True, 'int8'),      # K = 64 in one 64-byte K block, two groups of N
])
def test_wgmma_route_shapes_match_jax(m, k, n, a_packed, res, out_mode):
    """Calls the ``wgmma`` route takes (its plain version here) against the
    JAX kernel in interpret mode: codes equal to exact arithmetic, JAX within
    one step at under 1e-3 of the codes."""
    assert i4.int4_route(k, a_packed) == 'wgmma'
    case = _case(13, m, k, n, res=res)
    kw = dict(res_scale=0.11 if res else None, out_scale=0.07, relu=True, out_mode=out_mode,
              qmax=7.0)
    got, want = _both(case, a_packed=a_packed, **kw)
    _assert_codes(got, want, _exact(case, **kw), out_mode)


def test_matmul_f32_mode_honours_out_dtype_and_none_beta():
    case = _case(6, 9, 64, 24)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    bf = i4.int4_matmul(t['a'], t['b'], t['alpha'], t['beta'], out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, i4.int4_matmul(t['a'], t['b'], t['alpha'], t['beta'], out_mode='bf16'))
    none = i4.int4_matmul(t['a'], t['b'], t['alpha'], None)
    zero = i4.int4_matmul(t['a'], t['b'], t['alpha'], torch.zeros(24))
    assert torch.equal(none, zero)


def test_wrapper_contract_and_shape_errors():
    """On the CPU the wrapper runs the plain version and counts no launch; the
    launch itself takes CUDA tensors only; the JAX function's shape rules
    raise."""
    z = lambda *s: torch.zeros(*s, dtype=torch.int8)  # noqa: E731
    ones = torch.ones(256)
    before = counters.snapshot()
    i4.int4_matmul(z(4, 128), z(256, 256), ones, None, a_packed=True)
    assert counters.since(before) == {}
    with pytest.raises(ValueError, match='CUDA'):
        i4.launch(z(4, 256), z(256, 256), ones, None, None, None, None, False, False, 'f32',
                  127.0, torch.float32)
    with pytest.raises(ValueError, match='multiple of 256'):       # K % 256 when packed
        i4.int4_matmul(z(4, 64), z(128, 256), ones, None, a_packed=True)
    with pytest.raises(ValueError, match='multiple of 256'):       # [M, K/2] bytes
        i4.int4_matmul(z(4, 256), z(256, 256), ones, None, a_packed=True)
    with pytest.raises(ValueError, match='group alignment'):       # packed out, N % 256
        i4.int4_matmul(z(4, 64), z(64, 128), ones[:128], None, out_mode='packed', out_scale=1.0)
    with pytest.raises(ValueError, match='group alignment'):       # residual, N % 256
        i4.int4_matmul(z(4, 64), z(64, 128), ones[:128], None, residual=z(4, 64), res_scale=1.0)
    with pytest.raises(ValueError, match='residual must be'):
        i4.int4_matmul(z(4, 64), z(64, 256), ones, None, residual=z(4, 256), res_scale=1.0)
    with pytest.raises(ValueError, match='needs res_scale'):
        i4.int4_matmul(z(4, 64), z(64, 256), ones, None, residual=z(4, 128))
    with pytest.raises(ValueError, match='needs out_scale'):
        i4.int4_matmul(z(4, 64), z(64, 256), ones, None, out_mode='int8')
    with pytest.raises(ValueError, match='out_mode'):
        i4.int4_matmul(z(4, 64), z(64, 256), ones, None, out_mode='int4')
    with pytest.raises(ValueError, match='cannot multiply'):
        i4.int4_matmul(z(4, 32), z(64, 256), ones, None)
    with pytest.raises(TypeError, match='int8'):
        i4.int4_matmul(z(4, 64).float(), z(64, 256), ones, None)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        i4.int4_matmul(z(4, 64), z(64, 256), ones, None, out_dtype=torch.float16)


@pytest.mark.cuda
def test_int4_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(0)

    def codes(shape, lo=-7, hi=8):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int8).cuda()

    for m, k, n in ((300, 256, 256), (13, 512, 512), (70, 64, 256)):
        a, bt = codes((m, k)), codes((n, k))
        alpha, beta = (torch.rand(n, generator=g) * 1e-2).cuda(), torch.randn(n, generator=g).cuda()
        res = i4.pack_int4(codes((m, n)))
        for a_packed in (False, True):
            a_in = i4.pack_int4(a) if a_packed else a
            for mode in ('f32', 'int8', 'packed'):
                for with_res in (False, True):
                    kw = dict(residual=res if with_res else None, res_scale=0.11, out_scale=0.07,
                              a_packed=a_packed, fuse_relu=True, out_mode=mode, out_qmax=7.0)
                    got = i4.int4_matmul(a_in, bt.t(), alpha, beta, **kw)
                    want = i4.int4_matmul_plain(a_in, bt.t(), alpha, beta, **kw)
                    assert torch.equal(got, want), (m, k, n, a_packed, mode, with_res)
