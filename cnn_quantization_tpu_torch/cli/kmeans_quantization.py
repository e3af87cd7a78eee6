"""Offline k-means (non-uniform) weight quantization CLI.

Port of ``cnn_quantization_tpu/cli/kmeans_quantization.py`` (reference
pytorch_quantizer/quantization/kmeans_quantization.py): cluster each
eligible weight tensor's values into 2^bits centroids (``quantize``) or clip
them to the centroids' range (``clip``), save the result, then save a
bias-corrected variant (each output channel's mean shift removed).  The
JAX package clusters with scikit-learn on the host; the port runs its own
1-D k-means in torch on the device (``kmeans1d``): quantile initialisation,
then Lloyd's iterations, each value assigned to the nearest of the sorted
centroids (``torch.searchsorted``/``torch.bucketize`` against their
midpoints), until no value moves.  Deterministic.

Skip rules mirror ``is_ignored`` (kmeans_quantization.py:33-39) in the
port's layout: the classifier (``[1000, in]``), the first layer (OIHW with
in_ch == 3), the aux towers; biases and BN entries are never clustered.

The output is the JAX package's ``.npz`` layout (``utils/flax_params.
flax_from_state_dict``, ``utils/checkpoint.save_params_npz``), so both
packages' ``inference_sim --weights`` read it.

  python -m cnn_quantization_tpu_torch.cli.kmeans_quantization -a resnet50 \\
      --weights resnet50.pth -bits 4 [-t clip] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def kmeans1d(x: torch.Tensor, k: int, max_iter: int = 300):
    """1-D k-means of the values of ``x``: (sorted centroids [k'] float32,
    the index of each value's centroid, shaped like ``x``, inertia as a
    float, iterations run).  ``k'`` = min(k, distinct values).  Starts from
    the values' (i + 1/2)/k quantiles; Lloyd's iterations assign each value
    to the nearest centroid (a value on a midpoint to the lower one) and move
    each centroid to its cluster's mean, until the assignment stops changing
    or ``max_iter``.  In one dimension a cluster is an interval of the sorted
    values, so an iteration finds the k - 1 boundaries by binary search and
    the clusters' sums from one prefix sum (float64): O(k log n), not O(n)."""
    flat = x.detach().reshape(-1).double()
    values = torch.sort(flat).values
    n = values.numel()
    k = min(k, int((values[1:] != values[:-1]).sum()) + 1)
    pos = ((torch.arange(k, device=values.device, dtype=torch.float64) + 0.5) * n / k).long()
    centroids = torch.unique(values[pos.clamp(max=n - 1)])
    prefix = torch.cat([values.new_zeros(1), torch.cumsum(values, 0)])
    ends = values.new_full((1,), n, dtype=torch.long)
    edges, it = None, 0
    for it in range(1, max_iter + 1):
        bounds = torch.searchsorted(values, (centroids[1:] + centroids[:-1]) / 2, side='right')
        new_edges = torch.cat([ends.new_zeros(1), bounds, ends])
        if edges is not None and torch.equal(new_edges, edges):
            break
        edges = new_edges
        counts = edges[1:] - edges[:-1]
        sums = prefix[edges[1:]] - prefix[edges[:-1]]
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1), centroids)
    index = torch.bucketize(flat, (centroids[1:] + centroids[:-1]) / 2)
    inertia = float(((flat - centroids[index]) ** 2).sum())
    return centroids.float(), index.reshape(x.shape), inertia, it


def quantize1d_kmeans(x: torch.Tensor, num_bits: int = 8):
    """(each value replaced by its centroid, inertia)."""
    centroids, index, inertia, _ = kmeans1d(x, 2 ** num_bits)
    return centroids[index].to(x.dtype), inertia


def clip1d_kmeans(x: torch.Tensor, num_bits: int = 8):
    """(values clipped to the centroids' range, inertia of the clustering)."""
    centroids, _, inertia, _ = kmeans1d(x, 2 ** num_bits)
    return x.clamp(float(centroids[0]), float(centroids[-1])), inertia


def is_ignored(name: str, weight: torch.Tensor) -> bool:
    """Classifier, first layer and aux-tower weights stay float32."""
    if weight.ndim == 2 and weight.shape[0] == 1000:
        return True
    if weight.ndim == 4 and weight.shape[1] == 3:  # OIHW in_ch == 3
        return True
    return 'AuxLogits' in name or 'Conv2d_2a_3x3' in name


def weight_names(params):
    """The conv (4-D) and linear (2-D) weights of a state dict."""
    return [k for k, v in params.items() if k.endswith('.weight') and v.ndim in (2, 4)]


@torch.no_grad()
def process_params(params, num_bits: int, task: str = 'quantize', bias_corr: bool = False):
    """(a new state dict with the eligible weights k-means quantized or
    clipped, {weight name: inertia})."""
    fn = quantize1d_kmeans if task == 'quantize' else clip1d_kmeans
    out, inertia = dict(params), {}
    for name in weight_names(params):
        w = params[name]
        if is_ignored(name, w):
            continue
        wq, inertia[name] = fn(w, num_bits=num_bits)
        if bias_corr:
            dims = tuple(range(1, w.ndim))
            wq = wq - (wq.mean(dim=dims, keepdim=True) - w.mean(dim=dims, keepdim=True))
        out[name] = wq.float()
    return out, inertia


def load_state(arch: str, weights: str | None, device=None, seed: int = 0):
    """A state dict of ``arch`` on ``device`` (the card unless ``'cpu'``):
    from the JAX package's ``.npz`` tree, a torchvision ``.pth``, or seeded
    random weights."""
    from ..models import build_model
    from ..utils.checkpoint import load_params_npz, load_torchvision_state_dict
    from ..utils.device import resolve_device
    from ..utils.flax_params import state_dict_from_flax
    dev = resolve_device(device)
    model, meta = build_model(arch, device=dev, seed=seed)
    if weights and weights.endswith('.npz'):
        state = state_dict_from_flax(load_params_npz(weights), meta.arch)
        model.load_state_dict({k: v.to(dev) for k, v in state.items()})
    elif weights:
        model.load_state_dict(load_torchvision_state_dict(weights, meta.arch, meta.fold_bn, dev))
    else:
        print('=> no weights; random init (demo mode)')
    return dict(model.state_dict())


def save(path: str, params, arch: str):
    from ..utils.checkpoint import save_params_npz
    from ..utils.flax_params import flax_from_state_dict
    save_params_npz(path, flax_from_state_dict(params, arch))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--arch', '-a', default='resnet18')
    p.add_argument('--weights', '-w', default=None,
                   help='.npz params or torch .pth (random init if absent)')
    p.add_argument('-bits', '--num_bits', default=4, type=int)
    p.add_argument('-t', '--task', default='quantize', choices=['quantize', 'clip'])
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    p.add_argument('--out_dir', default=os.path.join(os.path.expanduser('~'),
                                                     'mxt-sim-tpu', 'models'))
    return p


def run(args):
    """The CLI's work: the weights k-means processed and saved, then the
    bias-corrected variant.  Returns {'plain' | 'bcorr': {'path', 'seconds',
    'inertia', 'leaves', 'params'}}."""
    params = load_state(args.arch, args.weights, args.device)
    print(f'{args.task} {args.arch} to {args.num_bits} bits')
    path = os.path.join(args.out_dir, f'{args.arch}_kmeans{args.num_bits}bit.npz')
    report = {}
    for key, out in (('plain', path), ('bcorr', path.replace('.npz', '_bcorr.npz'))):
        t0 = time.perf_counter()
        pq, inertia = process_params(params, args.num_bits, args.task, bias_corr=key == 'bcorr')
        if pq and next(iter(pq.values())).is_cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        save(out, pq, args.arch)
        what = 'with bias correction ' if key == 'bcorr' else ''
        print(f'Saved quantized model {what}to {out} ({len(inertia)} weights clustered in '
              f'{seconds:.2f}s, inertia {sum(inertia.values()):.6g})')
        report[key] = dict(path=out, seconds=seconds, inertia=inertia, params=pq)
    return report


def main(argv=None):
    run(build_parser().parse_args(argv))
    print('Done')
    return 0


if __name__ == '__main__':
    sys.exit(main())
