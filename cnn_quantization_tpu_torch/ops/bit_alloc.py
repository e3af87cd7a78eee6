"""Per-channel bit allocation under a total bit budget.

Port of ``cnn_quantization_tpu/ops/bit_alloc.py`` (reference
int_quantizer.py:128-145, 381-407).  Given per-channel dispersions alpha_i,
B = C * 2**target bins are shared as bins_i = B * alpha_i^(2/3) / sum_j
alpha_j^(2/3) and bits_i = clamp(round-or-ceil(log2 bins_i), 0, 8).
"""

from __future__ import annotations

import torch

from ..utils.device import as_f32

_MAX_ITERS = 10


def get_omega(sigma, target_bins):
    """Real-valued per-channel bin counts (int_quantizer.py:128-135)."""
    sigma = sigma.float()
    B = sigma.shape[0] * as_f32(target_bins, sigma.device)
    p = sigma ** (2.0 / 3.0)
    return B * p / torch.sum(p)


def get_bits_alloc(alpha, num_bits, round_mode: bool = False):
    """Integer per-channel bit widths from dispersions ``alpha``
    (int_quantizer.py:381-391).  ``num_bits`` may be fractional."""
    alpha = alpha.float()
    B = alpha.shape[0] * torch.pow(2.0, as_f32(num_bits, alpha.device))
    p = alpha ** (2.0 / 3.0)
    bin_alloc = B * p / torch.sum(p)
    log_bins = torch.log2(bin_alloc)
    bit_alloc = torch.round(log_bins) if round_mode else torch.ceil(log_bins)
    # log2(0) = -inf lands in the lower clamp, like the reference's masked fill
    return torch.clamp(torch.nan_to_num(bit_alloc, nan=0.0, neginf=0.0, posinf=8.0),
                       0.0, 8.0)


def get_bits_alloc_fixed_target(alpha, num_bits, round_mode: bool = False):
    """Feedback iteration so that mean(bits) ~= num_bits
    (int_quantizer.py:393-407): up to 10 steps of
    target += (goal - mean(bits)) / 2, stopping once |2 * delta| <= 0.01.

    The JAX package writes this as a ``lax.while_loop`` with a data-dependent
    exit.  Here it is a fixed 10-step loop whose state freezes with
    ``torch.where`` once the exit condition holds: the same bits, and no
    device-to-host read, which would stall every dynamic site on every batch.
    """
    alpha = alpha.float()
    goal = as_f32(num_bits, alpha.device)
    target = goal
    delta = torch.ones((), dtype=torch.float32, device=alpha.device)
    bits = torch.zeros_like(alpha)
    for _ in range(_MAX_ITERS):
        active = torch.abs(2.0 * delta) > 0.01
        new_bits = get_bits_alloc(alpha, target, round_mode)
        new_delta = (goal - torch.mean(new_bits)) / 2.0
        bits = torch.where(active, new_bits, bits)
        target = torch.where(active, target + new_delta, target)
        delta = torch.where(active, new_delta, delta)
    return bits
