"""Pairwise inter-sample activation angle statistics.

Port of ``cnn_quantization_tpu/calib/angle_stats.py`` (reference
pytorch_quantizer/quantization/inference/angle_stats.py): for each tapped
layer output [N, ...], the upper-triangular N x N matrix of angles
acos(cos_sim(x_i, x_j)) between flattened per-sample activations, stacked
across batches and pickled with the targets to ``<folder>/angle.pkl``.

Each matrix is one normalized Gram product on the activation's device.  The
artifact holds numpy arrays: the JAX package's holds pandas DataFrames of
the same values, and the card's machine has no pandas.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def angle_matrix(acts: torch.Tensor) -> torch.Tensor:
    """[N, ...] activations -> [N, N] upper-triangular matrix of pairwise
    angles (radians); zero on and below the diagonal, like the reference."""
    x = acts.float().reshape(acts.shape[0], -1)
    norm = torch.linalg.norm(x, dim=1, keepdim=True)
    xn = x / norm.clamp_min(1e-12)
    ang = torch.arccos(torch.clamp(xn @ xn.T, -1.0, 1.0))
    n = x.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=x.device), diagonal=1)
    return torch.where(upper, ang, 0.0)


class AngleStats:
    """Accumulate per-site angle matrices across batches and persist them:
    a pickle of {site_id: ndarray [N_total, N_batch], 'target': ndarray} at
    ``<folder>/angle.pkl`` (reference angle_stats.py:56-73)."""

    def __init__(self, folder: str):
        self.folder = folder
        self.stats: dict[str, np.ndarray] = {}
        self.targets = np.zeros((0,), np.int64)

    @torch.no_grad()
    def update(self, captured: dict, targets=None):
        """``captured``: {site_id: [N, ...] activation} (``CaptureContext``
        output); the matrices come to the host in one copy."""
        sites = list(captured)
        if sites:
            mats = torch.stack([angle_matrix(captured[s]) for s in sites]).cpu().numpy()
            for site, m in zip(sites, mats):
                prev = self.stats.get(site)
                self.stats[site] = m if prev is None else np.vstack([prev, m])
        if targets is not None:
            self.targets = np.concatenate([self.targets, np.asarray(targets).ravel()])

    def save(self) -> str:
        os.makedirs(self.folder, exist_ok=True)
        out = dict(self.stats)
        out['target'] = self.targets
        path = os.path.join(self.folder, 'angle.pkl')
        with open(path, 'wb') as f:
            pickle.dump(out, f)
        return path


def load_angle_stats(path: str) -> dict:
    """The pickle ``AngleStats.save`` wrote (unpickle only files this program
    wrote)."""
    with open(path, 'rb') as f:
        return pickle.load(f)
