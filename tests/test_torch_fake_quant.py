"""The port's fake-quant (plain version on the CPU) against the JAX package.

Modes (a) and (c) must be bit-exact in float32 (``atol=0``): both sides run
the same IEEE operations in the same order.  bf16 may differ by at most one
grid step.  Stochastic rounding uses different generators on the two sides,
so it is checked by its statistics.  The ``cuda`` test holds the CUDA kernel
against the plain version on the card and skips here.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cnn_quantization_tpu.ops import quant_math as jqm
from cnn_quantization_tpu.ops.kernels import fake_quant_fused as j_fused

from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.utils import counters


def _nchw(x_nhwc):
    """NHWC numpy -> NCHW channels_last torch (the port's activation layout)."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_per_tensor_bit_exact():
    rng = np.random.RandomState(0)
    x = rng.randn(37, 150).astype(np.float32)
    delta, offset = float(x.max() - x.min()), float(x.min())
    want = np.asarray(jqm.fake_quant(x, delta, offset, 15.0))
    got = fq.fake_quant_fused(torch.from_numpy(x), delta, offset, 15.0).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(j_fused(x, delta, offset, 15.0, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-6)


@pytest.mark.parametrize('zero_bit_channels', [False, True])
def test_per_channel_vector_qmax_bit_exact(zero_bit_channels):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 7, 7, 64).astype(np.float32) * rng.rand(64).astype(np.float32)
    min_c, max_c = x.min(axis=(0, 1, 2)), x.max(axis=(0, 1, 2))
    bits = rng.randint(1, 9, 64)
    if zero_bit_channels:
        bits[::5] = 0  # bit allocation can give a channel 0 bits (qmax 0)
    qmax = (2.0 ** bits - 1).astype(np.float32)
    want = np.asarray(jqm.fake_quant(x, max_c - min_c, min_c, qmax, channel_axis=-1))
    got = fq.fake_quant_fused(_nchw(x), torch.from_numpy(max_c - min_c),
                              torch.from_numpy(min_c), torch.from_numpy(qmax),
                              channel_dim=1)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_per_channel_scalar_qmax_oihw_weight():
    rng = np.random.RandomState(2)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)  # HWIO
    min_c, max_c = w.min(axis=(0, 1, 2)), w.max(axis=(0, 1, 2))
    want = np.asarray(jqm.fake_quant(w, max_c - min_c, min_c, 255.0, channel_axis=-1))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = fq.fake_quant_fused(w_oihw, torch.from_numpy(max_c - min_c),
                              torch.from_numpy(min_c), 255.0, channel_dim=0)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize('case', ['straddles', 'positive', 'empty_range'])
def test_kernel_semantics_bit_exact(case):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 9, 8).astype(np.float32)
    delta, offset = {'straddles': (float(x.max() - x.min()), float(x.min())),
                     'positive': (3.0, 0.25),
                     'empty_range': (0.0, 1.5)}[case]
    want = np.asarray(jqm.fake_quant_kernel_semantics(x, delta, offset, 8))
    got = fq.fake_quant_kernel_semantics_fused(_nchw(x), delta, offset, 8)
    np.testing.assert_array_equal(_nhwc(got), want)
    if case == 'empty_range':
        np.testing.assert_array_equal(_nhwc(got), x)


def test_bf16_within_one_grid_step():
    rng = np.random.RandomState(4)
    x32 = rng.randn(16, 128).astype(np.float32)
    got = fq.fake_quant_fused(torch.from_numpy(x32).bfloat16(), 4.0, -2.0, 255.0)
    assert got.dtype == torch.bfloat16
    want = jqm.fake_quant(jnp.asarray(x32, jnp.bfloat16), 4.0, -2.0, 255.0)
    step = 4.0 / 255.0
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= step + 1e-6, diff.max()


def test_stochastic_statistics_match_pallas_semantics():
    """Unbiased, seed-dependent, reproducible; the same bounds as the
    Pallas kernel's on-chip check (bench.py:391-418)."""
    rs = np.random.RandomState(0)
    n = 64 * 1024
    delta, qmax = 4.0, 15.0
    x = torch.from_numpy(rs.rand(n // 256, 256).astype(np.float32) * delta)
    a = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=7)
    b = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=8)
    a2 = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=7)
    det = fq.fake_quant_fused(x, delta, 0.0, qmax)
    step = delta / qmax
    bias = float((a - x).mean())
    se = step / np.sqrt(12.0 * n)
    assert abs(bias) < 6 * se, (bias, se)
    assert 0.17 < float((a != det).float().mean()) < 0.33
    assert 0.25 < float((a != b).float().mean()) < 0.42
    assert torch.equal(a, a2)
    # the Pallas interpret path draws from the same distribution
    j = np.asarray(j_fused(x.numpy(), delta, 0.0, qmax, stochastic=True, seed=7,
                           interpret=True))
    j_bias = float(np.mean(j - x.numpy()))
    assert abs(j_bias) < 6 * se and abs(bias - j_bias) < 12 * se


def test_cpu_runs_plain_and_counts_no_launch():
    before = counters.snapshot()
    x = torch.randn(4, 8)
    fq.fake_quant_fused(x, 2.0, -1.0, 15.0)
    fq.fake_quant_kernel_semantics_fused(x, 2.0, -1.0, 4)
    assert counters.since(before) == {}


def test_non_cuda_device_raises():
    x = torch.empty(4, 8, device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        fq.fake_quant_fused(x, torch.tensor(2.0, device='meta'),
                            torch.tensor(-1.0, device='meta'),
                            torch.tensor(15.0, device='meta'))


def test_memory_layout_rule():
    """The kernel sees x as [outer, C, inner] in memory order."""
    act = torch.empty(2, 5, 3, 3).to(memory_format=torch.channels_last)
    assert fq.memory_layout(act, 1) == (5, 1)
    w = torch.empty(16, 8, 3, 3)
    assert fq.memory_layout(w, 0) == (16, 72)
    rows = torch.empty(4, 300)
    assert fq.memory_layout(rows, 0) == (4, 300)
    assert fq.memory_layout(act, None) == (1, 1)
    with pytest.raises(ValueError):
        fq.memory_layout(torch.empty(4, 6).t(), 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(8, 64, 14, 14, device='cuda', generator=g).to(
        memory_format=torch.channels_last)
    mn, mx = x.amin(dim=(0, 2, 3)), x.amax(dim=(0, 2, 3))
    qmax = torch.pow(2.0, torch.randint(0, 5, (64,), device='cuda').float()) - 1
    got = fq.fake_quant_fused(x, mx - mn, mn, qmax, channel_dim=1)
    want = fq.fake_quant_fused_plain(x, mx - mn, mn, qmax, channel_dim=1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = fq.fake_quant_kernel_semantics_fused(x, mx.max() - mn.min(), mn.min(), 8)
    want = fq.fake_quant_kernel_semantics_plain(x, mx.max() - mn.min(), mn.min(), 8)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
