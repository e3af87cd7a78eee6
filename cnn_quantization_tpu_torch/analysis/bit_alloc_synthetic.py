"""Synthetic validation of the sigma^(2/3) per-channel bin-allocation rule.

Port of ``cnn_quantization_tpu/analysis/bit_alloc_synthetic.py`` (reference
bit_allocation_synthetic.py): two synthetic Gaussian channels share a bin
budget; sweeping the split shows the MSE minimum where the sigma^(2/3) rule
predicts it (eq. 11 of the paper).  The draws and the quantization run in
torch on the given device (the card unless ``'cpu'``) from an explicit
``torch.Generator``.

  python -m cnn_quantization_tpu_torch.analysis.bit_alloc_synthetic
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.device import resolve_device
from .mse_analysis import uniform_midtread_quantize


def split_mse(x: torch.Tensor, y: torch.Tensor, total_bins: float, fracs) -> np.ndarray:
    """MSE of quantizing x with frac*B bins and y with (1-frac)*B bins."""
    out = []
    for f in fracs:
        step_x = (x.max() - x.min()) / (float(f) * total_bins)
        step_y = (y.max() - y.min()) / ((1 - float(f)) * total_bins)
        mse_x = ((uniform_midtread_quantize(x, step_x) - x) ** 2).mean()
        mse_y = ((uniform_midtread_quantize(y, step_y) - y) ** 2).mean()
        out.append(mse_x + mse_y)
    return torch.stack(out).cpu().numpy()


def optimal_fraction(sigma_x: float, sigma_y: float) -> float:
    """The rule's prediction: bins_x / B = sx^(2/3) / (sx^(2/3) + sy^(2/3))."""
    px, py = sigma_x ** (2 / 3), sigma_y ** (2 / 3)
    return px / (px + py)


def run(sigma_x=2.82845653294, sigma_y=1.0, n=100_000, total_bins=32.0, seed=0, device=None):
    """(fractions, MSE at each) of the two-channel split sweep."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = sigma_x * torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    y = sigma_y * torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    fracs = np.arange(0.15, 0.85, 0.01)
    return fracs, split_mse(x, y, total_bins, fracs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = p.parse_args(argv)
    fracs, mses = run(device=args.device)
    best = fracs[int(np.argmin(mses))]
    pred = optimal_fraction(2.82845653294, 1.0)
    print(f'empirical optimal fraction: {best:.3f}; sigma^(2/3) rule: {pred:.3f}')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.plot(fracs, mses, 'b', linewidth=3)
        plt.axvline(pred, color='r', linestyle='--', label='sigma^(2/3) rule')
        plt.xlabel('fraction of bins allocated to channel i')
        plt.ylabel('Mean Square Error'); plt.legend()
        plt.savefig('bit_alloc_synthetic.png', dpi=120)
        print('saved bit_alloc_synthetic.png')
    except ImportError as e:   # matplotlib is optional
        print(f'(no figure: {e})')


if __name__ == '__main__':
    main()
