"""The port's numerics core against the JAX package on the same numpy inputs.

Tolerances:
  * statistics: 1e-6 relative (reduction order differs between XLA and
    PyTorch); kurtosis 1e-5, since its fourth power of (x - mean) / std
    multiplies the ulp differences of mean and std by four;
  * fake-quant outputs from identical parameters: bit-exact;
  * quantizer outputs whose parameters come from statistics of the tensor:
    within 1e-5 relative (a clip value from a mean or std carries that
    statistic's ulp differences into the scale), or one grid step at under
    0.1 % of elements, where such a difference puts a value on a rounding
    boundary (``assert_grid_close``);
  * bit allocations: equal.
NHWC activations are transposed to the port's NCHW, HWIO weights to OIHW.
"""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.ops import aciq as j_aciq
from cnn_quantization_tpu.ops import bias_corr as j_bc
from cnn_quantization_tpu.ops import bit_alloc as j_ba
from cnn_quantization_tpu.ops import quant_math as j_qm
from cnn_quantization_tpu.ops import quantizer as j_q
from cnn_quantization_tpu.ops import stats as j_stats

from cnn_quantization_tpu_torch.ops import aciq, bias_corr, bit_alloc, quant_math, stats
from cnn_quantization_tpu_torch.ops import quantizer as q


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def assert_grid_close(ours, ref, step, frac=1e-3):
    """Within 1e-5 relative, or off by one grid step (``step``, a scalar) at
    under ``frac`` of the elements."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(ours - ref)
    flipped = diff > 1e-5 * np.abs(ref) + 1e-6
    assert np.all(diff[flipped] <= step * 1.001 + 1e-6), diff.max()
    assert flipped.mean() < frac, f'{flipped.mean():.2e} of elements a grid step off'


# ---------------------------------------------------------------- quant_math

def test_affine_qparams_and_helpers_bit_exact():
    rng = np.random.RandomState(0)
    delta = np.abs(rng.randn(32)).astype(np.float32)
    offset = rng.randn(32).astype(np.float32)
    qmax = (2.0 ** rng.randint(0, 9, 32) - 1).astype(np.float32)
    s_j, z_j = j_qm.affine_qparams(delta, offset, qmax)
    s, z = quant_math.affine_qparams(torch.from_numpy(delta), torch.from_numpy(offset),
                                     torch.from_numpy(qmax))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_j))
    bits = rng.randint(0, 9, 16).astype(np.float32)
    np.testing.assert_array_equal(quant_math.qmax_for_bits(torch.from_numpy(bits)).numpy(),
                                  np.asarray(j_qm.qmax_for_bits(bits)))
    alpha, mx, mn, mean = (rng.rand(8).astype(np.float32) + 0.1 for _ in range(4))
    for half in (False, True):
        for clip2max in (False, True):
            want = j_qm.alpha_to_delta_offset(alpha, mx, -mn, mean - 0.5,
                                              half_range=half, clip2max=clip2max)
            got = quant_math.alpha_to_delta_offset(
                torch.from_numpy(alpha), torch.from_numpy(mx), torch.from_numpy(-mn),
                torch.from_numpy(mean - 0.5), half_range=half, clip2max=clip2max)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = j_qm.minmax_delta_offset(-mn, mx, half_range=half)
        got = quant_math.minmax_delta_offset(torch.from_numpy(-mn), torch.from_numpy(mx),
                                             half_range=half)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fake_quant_and_codes_bit_exact():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    mn, mx = x.min(axis=(0, 1, 2)), x.max(axis=(0, 1, 2))
    qmax = (2.0 ** rng.randint(0, 5, 8) - 1).astype(np.float32)
    want = j_qm.fake_quant(x, mx - mn, mn, qmax, channel_axis=-1)
    got = quant_math.fake_quant(nchw(x), torch.from_numpy(mx - mn), torch.from_numpy(mn),
                                torch.from_numpy(qmax), channel_axis=1)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))
    codes_j, _ = j_qm.quantize_codes(x, mx - mn, mn, qmax, channel_axis=-1)
    codes, (s, z) = quant_math.quantize_codes(nchw(x), torch.from_numpy(mx - mn),
                                              torch.from_numpy(mn), torch.from_numpy(qmax),
                                              channel_axis=1)
    np.testing.assert_array_equal(to_nhwc(codes), np.asarray(codes_j))
    np.testing.assert_array_equal(
        to_nhwc(quant_math.dequantize_codes(codes, s.reshape(-1), z.reshape(-1),
                                            channel_axis=1)), np.asarray(want))


# --------------------------------------------------------------------- stats

RTOL = {k: 1e-6 for k in ('min', 'max', 'mean', 'std', 'b', 'mean_abs', 'std_pos')}
RTOL['kurtosis'] = 1e-5


@pytest.mark.parametrize('avg', [False, True])
def test_stats_match(avg):
    rng = np.random.RandomState(2)
    x = (rng.laplace(0, 1.0, (3, 6, 6, 5)) + rng.randn(5)).astype(np.float32)
    names = ['min', 'max', 'mean', 'std', 'b', 'mean_abs', 'kurtosis', 'std_pos']
    want = j_stats.act_stats_per_channel(x, names, avg_over_batch=avg)
    got = stats.act_stats_per_channel(nchw(x), names, channel_axis=1, avg_over_batch=avg)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL[k],
                                   atol=1e-6, err_msg=k)
    want = j_stats.act_stats(x, names, avg_over_batch=avg)
    got = stats.act_stats(nchw(x), names, avg_over_batch=avg)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL[k],
                                   atol=1e-6, err_msg=k)
    w = rng.randn(3, 3, 4, 7).astype(np.float32)
    want = j_stats.weight_stats_per_channel(w, names)
    got = stats.weight_stats_per_channel(oihw(w), names, out_axis=0)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL[k],
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------- aciq

def test_aciq_tables_and_alpha():
    for name in ('LAPLACE_TABLE', 'LAPLACE_POSITIVE_TABLE', 'GAUS_TABLE',
                 'GAUS_POSITIVE_TABLE', 'EXP_TABLE', 'OMEGA_TABLE', 'ALPHA_MULT_TABLE'):
        np.testing.assert_array_equal(getattr(aciq, name), getattr(j_aciq, name))
    rng = np.random.RandomState(3)
    b = rng.rand(16).astype(np.float32)
    bits = rng.randint(0, 9, 16).astype(np.float32)
    for half in (False, True):
        np.testing.assert_array_equal(
            aciq.alpha_laplace(torch.from_numpy(b), torch.from_numpy(bits), half_range=half).numpy(),
            np.asarray(j_aciq.alpha_laplace(b, bits.astype(np.int32), half_range=half)))
        np.testing.assert_array_equal(
            aciq.alpha_gaus(torch.from_numpy(b), 4, half_range=half).numpy(),
            np.asarray(j_aciq.alpha_gaus(b, 4, half_range=half)))
    np.testing.assert_array_equal(aciq.alpha_pstd(torch.from_numpy(b), 2.0).numpy(),
                                  np.asarray(j_aciq.alpha_pstd(b, 2.0)))
    omega = (rng.rand(16) * 50).astype(np.float32)
    np.testing.assert_allclose(aciq.alpha_mult_for_omega(torch.from_numpy(omega)).numpy(),
                               np.asarray(j_aciq.alpha_mult_for_omega(omega)), rtol=1e-6)


# ----------------------------------------------------------------- bit_alloc

@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('round_mode', [True, False])
def test_fixed_loop_bits_equal_while_loop(seed, round_mode):
    """The fixed 10-step torch.where loop gives the while_loop's bits."""
    rng = np.random.RandomState(seed)
    alpha = (np.abs(rng.randn(64)) * rng.choice([0.1, 1.0, 10.0], 64)).astype(np.float32)
    for target in (4.0, 3.5, 2.0):
        want = np.asarray(j_ba.get_bits_alloc_fixed_target(alpha, target, round_mode))
        got = bit_alloc.get_bits_alloc_fixed_target(torch.from_numpy(alpha), target,
                                                    round_mode).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(bit_alloc.get_omega(torch.from_numpy(alpha), 16.0).numpy(),
                               np.asarray(j_ba.get_omega(alpha, 16.0)), rtol=1e-5)


# ----------------------------------------------------------------- bias_corr

def test_bias_corr_matches():
    rng = np.random.RandomState(4)
    w = rng.randn(3, 3, 4, 8).astype(np.float32)
    wq = np.round(w * 4) / 4
    for var in (False, True):
        want = j_bc.weight_correction(w, wq, bias_corr=True, var_corr=var)
        got = bias_corr.weight_correction(oihw(w), oihw(wq), out_axis=0, var_corr=var)
        np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    out = rng.randn(2, 5, 5, 6).astype(np.float32)
    out_q = np.round(np.maximum(out, 0) * 3) / 3
    want = j_bc.activation_bias_correction(out, out_q)
    got = bias_corr.activation_bias_correction(nchw(out), nchw(out_q), channel_axis=1)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- quantizer

ACT_CASES = {
    # name: (QuantConfig kwargs, quantize_activation kwargs, input kind)
    'per_tensor_avg_over_batch': (dict(num_bits=8), dict(tag='activation'), 'randn'),
    'classifier_global': (dict(num_bits=8), dict(tag='activation_classifier'), 'fc'),
    'pcq_a_minmax': (dict(num_bits=8, pcq_a=True), {}, 'scaled'),
    'pcq_a_1x1_spatial': (dict(num_bits=8, pcq_a=True), dict(tag='activation'), '1x1'),
    'half_range': (dict(num_bits=8, pcq_a=True), dict(half_range=True), 'abs'),
    'laplace_pcq': (dict(num_bits=4, pcq_a=True, clipping='laplace'), {}, 'laplace'),
    'laplace_per_tensor': (dict(num_bits=4, clipping='laplace'), {}, 'laplace'),
    'headline_half': (dict(num_bits=4, pcq_a=True, clipping='laplace', bit_alloc_act=True),
                      dict(half_range=True), 'abs'),
    'bit_alloc_minmax': (dict(num_bits=4, pcq_a=True, bit_alloc_act=True), {}, 'scaled'),
    'gaus_2std': (dict(num_bits=4, clipping='2std', pcq_a=True), {}, 'randn'),
    'gaus': (dict(num_bits=4, clipping='gaus'), {}, 'randn'),
    'avgpool_pcq_w_quirk': (dict(num_bits=4, pcq_w=True, pcq_a=True, bit_alloc_weight=True),
                            dict(tag='default'), '1x1'),
    'entropy': (dict(num_bits=4, pcq_a=True, measure_entropy=True), {}, 'randn'),
}


def _act_input(kind, rng):
    if kind == 'fc':
        return rng.randn(4, 1000).astype(np.float32)
    if kind == '1x1':
        return rng.randn(4, 1, 1, 8).astype(np.float32)
    x = rng.randn(4, 8, 8, 8).astype(np.float32)
    if kind == 'scaled':
        x *= np.arange(1, 9, dtype=np.float32)
    elif kind == 'abs':
        x = np.abs(x) * np.linspace(0.1, 3, 8, dtype=np.float32)
    elif kind == 'laplace':
        x = rng.laplace(0, 1.0, x.shape).astype(np.float32)
    return x


@pytest.mark.parametrize('name', sorted(ACT_CASES))
def test_quantize_activation_matches(name):
    cfg_kw, call_kw, kind = ACT_CASES[name]
    rng = np.random.RandomState(sorted(ACT_CASES).index(name))
    x = _act_input(kind, rng)
    want, aux_j = j_q.quantize_activation(x, j_q.QuantConfig(**cfg_kw), **call_kw)
    xt = nchw(x) if x.ndim == 4 else torch.from_numpy(x)
    got, aux = q.quantize_activation(xt, q.QuantConfig(**cfg_kw), channel_axis=1, **call_kw)
    want = np.asarray(want)
    step = (want.max() - want.min()) / 255.0
    assert_grid_close(to_nhwc(got), want, max(step, 1e-3))
    if 'entropy' in aux_j:
        np.testing.assert_allclose(float(aux['entropy']), float(aux_j['entropy']), rtol=1e-3)


def test_quantize_activation_site_stats_bit_exact():
    rng = np.random.RandomState(20)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    st = {'mean_min': -np.abs(rng.randn(8)).astype(np.float32),
          'mean_max': np.abs(rng.randn(8)).astype(np.float32) + 0.5,
          'mean_mean': rng.randn(8).astype(np.float32) * 0.1,
          'mean_b': np.abs(rng.randn(8)).astype(np.float32) * 0.3,
          'mean_std': np.abs(rng.randn(8)).astype(np.float32)}
    for cfg_kw in (dict(num_bits=4, pcq_a=True, clipping='laplace', bit_alloc_act=True),
                   dict(num_bits=8, pcq_a=True)):
        want, _ = j_q.quantize_activation(x, j_q.QuantConfig(**cfg_kw), site_stats=st)
        got, _ = q.quantize_activation(nchw(x), q.QuantConfig(**cfg_kw), site_stats=st,
                                       channel_axis=1)
        np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))
    scalar = {k: np.float32(v.mean()) for k, v in st.items()}
    want, _ = j_q.quantize_activation(x, j_q.QuantConfig(num_bits=8), site_stats=scalar)
    got, _ = q.quantize_activation(nchw(x), q.QuantConfig(num_bits=8), site_stats=scalar,
                                   channel_axis=1)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))


@pytest.mark.parametrize('cfg_kw', [dict(num_bits=8, pcq_w=True), dict(num_bits=8),
                                    dict(num_bits=4, pcq_w=True, bit_alloc_weight=True)],
                         ids=['pcq_w', 'per_tensor', 'bit_alloc'])
def test_quantize_weight_matches(cfg_kw):
    rng = np.random.RandomState(9)
    w = (rng.randn(3, 3, 4, 16) * np.linspace(0.1, 5, 16)).astype(np.float32)
    want, _ = j_q.quantize_weight(w, j_q.QuantConfig(**cfg_kw), out_axis=-1)
    got, _ = q.quantize_weight(oihw(w), q.QuantConfig(**cfg_kw), out_axis=0)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), np.asarray(want))

