"""Empirical study of per-channel weight-quantization bias.

Port of ``cnn_quantization_tpu/analysis/bias_correction.py`` (reference
bias_correction.ipynb): the normalized bias |E[w] - E[w_q]| / sigma(w) per
output channel after quantization, before and after the eq. 12/13
correction, over the OIHW conv weights of a state dict (the first layer,
in_ch == 3, excluded), through the port's ``quantize_weight`` and
``weight_correction``.

  python -m cnn_quantization_tpu_torch.analysis.bias_correction -a resnet18

writes a histogram where matplotlib is installed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.bias_corr import weight_correction
from ..ops.quantizer import QuantConfig, quantize_weight


@torch.no_grad()
def channel_bias(params, num_bits: int = 4):
    """{weight name: (bias after quantization, bias after correction)}, each
    a numpy vector over output channels."""
    cfg = QuantConfig(num_bits=num_bits, pcq_w=True)
    rows = {}
    for name, w in params.items():
        if not name.endswith('.weight') or w.ndim != 4 or w.shape[1] == 3:
            continue
        w = w.float()
        wq, _ = quantize_weight(w, cfg, out_axis=0)
        wc = weight_correction(w, wq, out_axis=0, bias_corr=True)
        flat = w.reshape(w.shape[0], -1)
        sig = flat.std(dim=1, correction=0) + 1e-12
        bias_q = (flat.mean(1) - wq.reshape(w.shape[0], -1).mean(1)).abs() / sig
        bias_c = (flat.mean(1) - wc.reshape(w.shape[0], -1).mean(1)).abs() / sig
        rows[name[:-len('.weight')]] = (bias_q.cpu().numpy(), bias_c.cpu().numpy())
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--arch', '-a', default='resnet18')
    p.add_argument('-bits', '--num_bits', default=4, type=int)
    p.add_argument('--weights', '-w', default=None,
                   help='torchvision .pth or the JAX package\'s .npz (random init if absent)')
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = p.parse_args(argv)

    from ..cli.kmeans_quantization import load_state
    params = load_state(args.arch, args.weights, args.device)
    rows = channel_bias(params, args.num_bits)
    all_q = np.concatenate([q for q, _ in rows.values()])
    all_c = np.concatenate([c for _, c in rows.values()])
    print(f'{args.arch} int{args.num_bits}: mean normalized channel bias '
          f'{all_q.mean():.4f} -> {all_c.mean():.6f} after correction '
          f'({len(rows)} layers, {all_q.size} channels)')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.hist(all_q, bins=60, alpha=0.6, label='quantized')
        plt.hist(all_c, bins=60, alpha=0.6, label='bias-corrected')
        plt.xlabel('|E[w] - E[w_q]| / sigma'); plt.legend()
        plt.savefig(f'{args.arch}_bias_err.png', dpi=120)
        print(f'saved {args.arch}_bias_err.png')
    except ImportError as e:   # matplotlib is optional
        print(f'(no figure: {e})')


if __name__ == '__main__':
    main()
