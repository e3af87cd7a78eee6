"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one, only an explicit ``'cpu'`` runs:
    asking for ``cuda`` (or nothing) on a machine with no GPU raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           'to run on the CPU')
    return dev


def use_full_fp32():
    """Run float32 convs and matmuls in full float32 on the card.  cuDNN
    convolves float32 in TF32 by default; TF32 keeps ~3 decimal digits, which
    moves values across 4-bit grid boundaries, and the JAX package's float32
    path has no TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def nhwc_to_nchw(images, device) -> torch.Tensor:
    """NHWC images (numpy or tensor, as ``data/synthetic.py`` yields them)
    -> a float32 NCHW view on ``device``.  The permuted view of an NHWC
    buffer is exactly the channels_last memory format, so nothing is copied
    beyond the move to the device."""
    t = torch.as_tensor(images, dtype=torch.float32).to(device)
    return t.permute(0, 3, 1, 2)


def as_f32(v, device) -> torch.Tensor:
    """A float32 tensor on ``device``.  Python numbers become a device-side
    fill (no host-to-device copy, so no synchronisation on the hot path)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if isinstance(v, (int, float, np.floating, np.integer)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)
