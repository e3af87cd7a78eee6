"""ACIQ analytical clipping: optimal alpha per prior and bit width.

Port of ``cnn_quantization_tpu/ops/aciq.py`` (reference int_quantizer.py:
34-51, 81-87, 227-325).  The tables are numpy constants, copied with the
numpy Newton solve that produces the omega/alpha tables; per-device tensor
copies are made once and cached, so a lookup on the card never copies from
the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import as_f32

# Optimal alpha/sigma for a Gaussian prior, bits 1..8 (int_quantizer.py:81-82).
ALPHA_GAUS = {1: 1.24, 2: 1.71, 3: 2.15, 4: 2.55, 5: 2.93, 6: 3.28, 7: 3.61, 8: 3.92}
ALPHA_GAUS_POSITIVE = {1: 1.71, 2: 2.15, 3: 2.55, 4: 2.93, 5: 3.28, 6: 3.61, 7: 3.92, 8: 4.2}

# Optimal alpha/b for a Laplace prior, bits 0..8 (int_quantizer.py:84-85).
ALPHA_LAPLACE = {0: 1.05, 1: 1.86, 2: 2.83, 3: 3.89, 4: 5.03, 5: 6.2, 6: 7.41, 7: 8.64, 8: 9.89}
ALPHA_LAPLACE_POSITIVE = {0: 1.86, 1: 2.83, 2: 3.89, 3: 5.02, 4: 6.2, 5: 7.41, 6: 8.64, 7: 9.89, 8: 11.16}

GAUSSIAN_CONST = (0.5 * 0.35) * (1 + (math.pi * math.log(4)) ** 0.5)

# Dense per-bit vectors (index = bit width 0..8).
LAPLACE_TABLE = np.asarray([ALPHA_LAPLACE[i] for i in range(9)], np.float32)
LAPLACE_POSITIVE_TABLE = np.asarray([ALPHA_LAPLACE_POSITIVE[i] for i in range(9)], np.float32)
GAUS_TABLE = np.asarray([ALPHA_GAUS[1]] + [ALPHA_GAUS[i] for i in range(1, 9)], np.float32)
GAUS_POSITIVE_TABLE = np.asarray(
    [ALPHA_GAUS_POSITIVE[1]] + [ALPHA_GAUS_POSITIVE[i] for i in range(1, 9)], np.float32)


def laplace_clipping_mse(b, alpha, num_bits):
    """Closed-form clipping+quantization MSE for Laplace(b) (mse_analysis.py:39-43)."""
    return 2.0 * (b ** 2) * np.exp(-alpha / b) + (alpha ** 2) / (3.0 * (2.0 ** (2 * num_bits)))


def gaussian_clipping_mse(sigma, alpha, num_bits):
    """Closed-form clipping+quantization MSE for N(0, sigma^2) (mse_analysis.py:10-16)."""
    clip = (sigma ** 2 + alpha ** 2) * (1 - math.erf(alpha / (sigma * np.sqrt(2.0)))) \
        - np.sqrt(2.0 / np.pi) * alpha * sigma * np.exp(-0.5 * alpha ** 2 / sigma ** 2)
    quant = (alpha ** 2) / (3.0 * (2.0 ** (2 * num_bits)))
    return clip + quant


def solve_alpha_laplace(num_bits: int, positive: bool = False) -> float:
    """Numerically minimize the Laplace clipping MSE (validates the tables);
    ``positive`` is the half-range case, equivalent to bits + 1."""
    from scipy.optimize import minimize_scalar
    bits = num_bits + 1 if positive else num_bits
    res = minimize_scalar(lambda a: laplace_clipping_mse(1.0, a, bits),
                          bounds=(0.1, 40.0), method='bounded')
    return float(res.x)


def _solve_alpha_for_omega(omega: np.ndarray) -> np.ndarray:
    """Solve 3*omega^2 * exp(-alpha) = alpha elementwise (Lambert W, Newton
    on a + log(a) - log(c)); the reference's minimize_scalar over
    laplace_prior_mse (int_quantizer.py:34-48) in closed form."""
    c = 3.0 * omega.astype(np.float64) ** 2
    a = np.maximum(np.log(np.maximum(c, 1e-30)), 0.5)
    for _ in range(50):
        g = a + np.log(a) - np.log(c)
        dg = 1.0 + 1.0 / a
        a = np.maximum(a - g / dg, 1e-8)
    return a


_RESOLUTION = 20
_OMEGA_TABLE = np.concatenate([
    np.linspace(0.01, 0.1, _RESOLUTION, endpoint=False),
    np.linspace(0.1, 1, _RESOLUTION, endpoint=False),
    np.linspace(1, 10, _RESOLUTION, endpoint=False),
    np.linspace(10, 100, _RESOLUTION, endpoint=False),
    np.linspace(100, 1000, _RESOLUTION, endpoint=False),
])
_ALPHA_TABLE = np.concatenate([[0.0], _solve_alpha_for_omega(_OMEGA_TABLE)])
_OMEGA_TABLE = np.concatenate([[0.0], _OMEGA_TABLE])

OMEGA_TABLE = np.asarray(_OMEGA_TABLE, np.float32)
ALPHA_MULT_TABLE = np.asarray(_ALPHA_TABLE, np.float32)


def _exp_coeff(num_bits: int) -> float:
    """Exponential-prior coefficient: (alpha/beta) e^(alpha/beta) = 12 * 4^M,
    the mid-tread Lambert-W solve with omega = 2 * 2^M."""
    return float(_solve_alpha_for_omega(np.asarray([2.0 * 2.0 ** num_bits]))[0])


EXP_TABLE = np.asarray([_exp_coeff(m) for m in range(9)], np.float32)

_TABLES = {'laplace': LAPLACE_TABLE, 'laplace_pos': LAPLACE_POSITIVE_TABLE,
           'gaus': GAUS_TABLE, 'gaus_pos': GAUS_POSITIVE_TABLE, 'exp': EXP_TABLE,
           'omega': OMEGA_TABLE, 'alpha_mult': ALPHA_MULT_TABLE}


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


def _lookup(name: str, stat, num_bits) -> torch.Tensor:
    """stat * table[clip(bits, 0, 8)]; ``num_bits`` is an int or a
    per-channel tensor of (integer-valued) bit widths."""
    stat = stat.float()
    if isinstance(num_bits, torch.Tensor):
        bits = num_bits.to(torch.int64).clamp(0, 8)
        return stat * _device_table(name, stat.device)[bits]
    return stat * float(_TABLES[name][min(max(int(num_bits), 0), 8)])


def alpha_laplace(b, num_bits, *, half_range: bool):
    """alpha = coeff(bits) * b (bit-allocation-aware, int_quantizer.py:236-253)."""
    return _lookup('laplace_pos' if half_range else 'laplace', b, num_bits)


def alpha_gaus(std, num_bits, *, half_range: bool):
    """alpha = coeff(bits) * sigma (int_quantizer.py:255-264)."""
    return _lookup('gaus_pos' if half_range else 'gaus', std, num_bits)


def alpha_pstd(std, p):
    """alpha = p * sigma ("2std"-style clipping, int_quantizer.py:266-275)."""
    return std.float() * float(np.float32(p))


def alpha_exp(mean, num_bits):
    """alpha = coeff(bits) * beta for a positive Exponential(beta) tensor."""
    return _lookup('exp', mean, num_bits)


def alpha_mult_for_omega(omega, sym: bool = True):
    """Piecewise-linear interpolation of the optimal clip multiplier for a
    real bin count omega (int_quantizer.py:137-145, ``get_alpha_mult``)."""
    dev = omega.device if isinstance(omega, torch.Tensor) else torch.device('cpu')
    omega = as_f32(omega, dev)
    if not sym:
        omega = omega * 2.0
    table_w = _device_table('omega', dev)
    table_a = _device_table('alpha_mult', dev)
    # jnp.searchsorted defaults to side='left', as torch.searchsorted does
    i = torch.clamp(torch.searchsorted(table_w, omega.contiguous()), 1,
                    table_w.shape[0] - 1)
    w_hi, w_lo = table_w[i], table_w[i - 1]
    a_hi, a_lo = table_a[i], table_a[i - 1]
    inc = (a_hi - a_lo) / (w_hi - w_lo)
    return a_hi - inc * (w_hi - omega)
