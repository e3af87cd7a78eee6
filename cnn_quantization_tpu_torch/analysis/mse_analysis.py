"""Analytic-vs-Monte-Carlo validation of the ACIQ clipping MSE.

Port of ``cnn_quantization_tpu/analysis/mse_analysis.py`` (reference
mse_analysis.py): the closed-form clipping + quantization MSE
(``ops/aciq.py``) against a simulation on Gaussian or Laplace draws; the
curves' minima are the alpha tables of ``ops/aciq.py``.  The simulation runs
in torch on the given device (the card unless ``'cpu'``) from an explicit
``torch.Generator``.

  python -m cnn_quantization_tpu_torch.analysis.mse_analysis --prior laplace -bits 4

writes the comparison figure where matplotlib is installed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.aciq import gaussian_clipping_mse, laplace_clipping_mse
from ..utils.device import resolve_device


def uniform_midtread_quantize(x: torch.Tensor, step) -> torch.Tensor:
    return torch.round(x / step) * step


def draw(prior: str, scale: float, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` float64 draws of Laplace(0, scale) (by the inverse CDF) or
    N(0, scale^2) from ``gen``."""
    if prior == 'laplace':
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=device) - 0.5
        return -scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())
    return scale * torch.randn(n, generator=gen, dtype=torch.float64, device=device)


def simulate_clipping_mse(samples: torch.Tensor, alphas, num_bits: int) -> np.ndarray:
    """Monte-Carlo MSE of clip-at-alpha + 2^bits mid-tread quantization."""
    out = []
    for alpha in alphas:
        alpha = float(alpha)
        s = uniform_midtread_quantize(samples.clamp(-alpha, alpha), (2 * alpha) / (2 ** num_bits))
        out.append(((s - samples) ** 2).mean())
    return torch.stack(out).cpu().numpy()


def compare(prior: str, num_bits: int, scale: float = 2.0, n: int = 100_000, seed: int = 0,
            device=None):
    """(alphas, analytic MSE, simulated MSE) over clipping values 0.5-10
    times ``scale``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    alphas = np.arange(0.5 * scale, 10 * scale, 0.05 * scale)
    mse = laplace_clipping_mse if prior == 'laplace' else gaussian_clipping_mse
    analytic = np.array([mse(scale, a, num_bits) for a in alphas])
    simulated = simulate_clipping_mse(draw(prior, scale, n, gen, dev), alphas, num_bits)
    return alphas, analytic, simulated


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--prior', default='laplace', choices=['laplace', 'gaus'])
    p.add_argument('-bits', '--num_bits', default=4, type=int)
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    p.add_argument('--out', default='mse_analysis.png')
    args = p.parse_args(argv)
    alphas, analytic, simulated = compare(args.prior, args.num_bits, device=args.device)
    i_a, i_s = int(np.argmin(analytic)), int(np.argmin(simulated))
    print(f'{args.prior} {args.num_bits}-bit: argmin analytic alpha={alphas[i_a]:.2f} '
          f'simulated alpha={alphas[i_s]:.2f}')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.plot(alphas, simulated, 'b', linewidth=4, label='simulation')
        plt.plot(alphas, analytic, 'r', linewidth=2, label='analysis')
        plt.legend(); plt.xlabel('Clipping Value'); plt.ylabel('Mean Square Error')
        plt.title(f'Bit Width={args.num_bits}')
        plt.savefig(args.out, dpi=120)
        print(f'saved {args.out}')
    except ImportError as e:   # matplotlib is optional
        print(f'(no figure: {e})')


if __name__ == '__main__':
    main()
