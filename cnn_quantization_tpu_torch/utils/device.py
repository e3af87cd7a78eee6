"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import spans


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one, only an explicit ``'cpu'`` runs:
    asking for ``cuda`` (or nothing) on a machine with no GPU raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           'to run on the CPU')
    return dev


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (its first line): every time and rate
    measured on the card is reported beside it."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def use_full_fp32():
    """Run float32 convs and matmuls in full float32 on the card.  cuDNN
    convolves float32 in TF32 by default; TF32 keeps ~3 decimal digits, which
    moves values across 4-bit grid boundaries, and the JAX package's float32
    path has no TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def nhwc_to_nchw(images, device, out: torch.Tensor | None = None) -> torch.Tensor:
    """NHWC images (numpy or tensor, as ``data/synthetic.py`` yields them)
    -> a float32 NCHW view on ``device``.  The permuted view of an NHWC
    buffer is exactly the channels_last memory format, so nothing is copied
    beyond the move to the device.  The move is the ``device.h2d`` span: from
    pinned host memory it returns once the copy is done, which waits for the
    work queued ahead of it.  ``out`` (a float32 NHWC tensor on ``device`` of
    the images' shape) receives the images in place of a new tensor."""
    with spans.span('device.h2d') as s:
        t = torch.as_tensor(images, dtype=torch.float32)
        t = t.to(device) if out is None else out.copy_(t)
        s.counts = {'bytes': t.numel() * 4}
    return t.permute(0, 3, 1, 2)


def as_f32(v, device) -> torch.Tensor:
    """A float32 tensor on ``device``.  Python numbers become a device-side
    fill (no host-to-device copy, so no synchronisation on the hot path)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if isinstance(v, (int, float, np.floating, np.integer)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)
