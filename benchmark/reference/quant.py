"""The quantization arithmetic of the two recipes, in plain PyTorch.

A frozen copy of the plain paths of the measured program's
``ops/quant_math.py``, ``ops/aciq.py`` (the Laplace table), ``ops/bit_alloc.py``,
``ops/bias_corr.py`` (the weight correction), ``ops/stats.py``,
``ops/kernels/int_matmul.py`` and ``ops/kernels/int_conv.py`` (their plain
versions), cut to the branches the benchmark's recipes take.  It imports
nothing of the program: the benchmark judges the program against it.

Every division is between tensors on one device (a division by a host number
multiplies by its reciprocal on the card) and the operations run in the
program's order, so that on one device the two agree bit for bit where the
program is sound.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SCALE_EPS = 1e-8
# optimal alpha / b of a Laplace prior, bits 0..8, full and half range
LAPLACE = (1.05, 1.86, 2.83, 3.89, 5.03, 6.2, 7.41, 8.64, 9.89)
LAPLACE_POSITIVE = (1.86, 2.83, 3.89, 5.02, 6.2, 7.41, 8.64, 9.89, 11.16)


def f32(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device`` (numbers as a device-side fill)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if isinstance(v, (int, float, np.floating, np.integer)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


# ---------------------------------------------------------------- statistics

def reduce_stats(t, names, dims) -> dict:
    """min, max, mean, std (ddof 1) and b = mean |t - mean| over ``dims``."""
    out = {}
    mean = torch.mean(t, dim=dims, keepdim=True) if {'mean', 'b'} & set(names) else None
    for s in names:
        if s == 'min':
            out[s] = torch.amin(t, dim=dims)
        elif s == 'max':
            out[s] = torch.amax(t, dim=dims)
        elif s == 'mean':
            out[s] = mean.squeeze(dims)
        elif s == 'std':
            out[s] = torch.std(t, dim=dims, correction=1)
        elif s == 'b':
            out[s] = torch.mean(torch.abs(t - mean), dim=dims)
        else:
            raise ValueError(s)
    return out


def tensor_stats(x, names) -> dict:
    return reduce_stats(x.float().reshape(-1), names, (0,))


def channel_stats(x, names, axis: int = 1) -> dict:
    t = x.float()
    return reduce_stats(t, names, tuple(i for i in range(t.ndim) if i != axis))


# ------------------------------------------------------------ affine grids

def affine_qparams(delta, offset, qmax, device):
    delta, offset, qmax = (f32(v, device) for v in (delta, offset, qmax))
    scale = torch.where(qmax > 0, delta / torch.clamp(qmax, min=1.0), 0.0)
    scale = torch.clamp(scale, min=SCALE_EPS)
    return scale, torch.round(-offset / scale)


def _bcast(v, ndim, axis):
    if v.ndim == 0:
        return v
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def fake_quant(x, delta, offset, qmax, axis=None):
    """Quantize to the uint grid [0, qmax] of range ``delta`` from ``offset``
    and back; per-channel parameters index ``axis``."""
    xf = x.float()
    scale, zp = affine_qparams(delta, offset, qmax, x.device)
    qmax = f32(qmax, x.device)
    if axis is not None:
        scale, zp, qmax = (_bcast(v, xf.ndim, axis) for v in (scale, zp, qmax))
    q = torch.round(torch.minimum((xf / scale + zp).clamp_min(0.0), qmax))
    return ((q - zp) * scale).to(x.dtype)


def fake_quant_minmax(x, delta, offset, num_bits: int):
    """The per-tensor min/max grid with the original CUDA kernel's rules: no
    scale floor, pass-through for delta <= 0, the rounded zero point only when
    the range straddles 0."""
    xf = x.float()
    dev = x.device
    delta, offset = f32(delta, dev), f32(offset, dev)
    qmax = 2.0 ** num_bits - 1.0
    scale = delta / f32(qmax, dev)
    safe = torch.where(delta > 0, scale, 1.0)
    zp = torch.round(-offset / safe)
    straddles = (offset + delta > 0) & (offset < 0)
    shift = torch.where(straddles, zp, -offset)
    q = torch.where(straddles, xf / safe + shift, (xf + shift) / safe)
    q = torch.round(q.clamp(0.0, qmax))
    deq = torch.where(straddles, (q - shift) * safe, q * safe - shift)
    return torch.where(delta > 0, deq, xf).to(x.dtype)


def qmax_for_bits(bits):
    return torch.pow(2.0, bits.float()) - 1.0


def alpha_laplace(b, bits, half_range: bool):
    table = LAPLACE_POSITIVE if half_range else LAPLACE
    b = b.float()
    if isinstance(bits, torch.Tensor):
        t = torch.as_tensor(np.asarray(table, np.float32), device=b.device)
        return b * t[bits.to(torch.int64).clamp(0, 8)]
    return b * float(np.float32(table[min(max(int(bits), 0), 8)]))


def alpha_to_delta_offset(alpha, max_v, min_v, mean, half_range: bool):
    if half_range:
        delta = mean.clamp_min(0.0) + alpha
        return delta, torch.zeros_like(delta)
    return 2.0 * alpha, torch.maximum(min_v, mean - alpha)


def minmax_delta_offset(min_v, max_v, half_range: bool):
    if half_range:
        min_v = torch.zeros_like(min_v)
    return max_v - min_v, min_v


# ---------------------------------------------------------- bit allocation

def bits_alloc(alpha, num_bits, round_mode: bool):
    alpha = alpha.float()
    B = alpha.shape[0] * torch.pow(2.0, f32(num_bits, alpha.device))
    p = alpha ** (2.0 / 3.0)
    log_bins = torch.log2(B * p / torch.sum(p))
    bits = torch.round(log_bins) if round_mode else torch.ceil(log_bins)
    return torch.clamp(torch.nan_to_num(bits, nan=0.0, neginf=0.0, posinf=8.0), 0.0, 8.0)


def bits_alloc_fixed_target(alpha, num_bits, round_mode: bool = True):
    """Ten steps of target += (goal - mean(bits)) / 2, each frozen once
    |2 * delta| <= 0.01: mean(bits) close to ``num_bits``."""
    alpha = alpha.float()
    goal = f32(num_bits, alpha.device)
    target = goal
    delta = torch.ones((), dtype=torch.float32, device=alpha.device)
    bits = torch.zeros_like(alpha)
    for _ in range(10):
        active = torch.abs(2.0 * delta) > 0.01
        new_bits = bits_alloc(alpha, target, round_mode)
        new_delta = (goal - torch.mean(new_bits)) / 2.0
        bits = torch.where(active, new_bits, bits)
        target = torch.where(active, target + new_delta, target)
        delta = torch.where(active, new_delta, delta)
    return bits


# ------------------------------------------------------- weight correction

def _sequential_sum(x):
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc


def windowed_sum(x, window: int = 32):
    """The sum of ``x [*R, O]`` over its leading dims: one element after
    another where no reduced dim exceeds ``window``, else in windows of that
    size along each reduced dim (a longer dim zero-padded half below, half
    above), each window summed in order, then the windows' sums likewise."""
    *red, o = x.shape
    if all(d <= window for d in red):
        return _sequential_sum(x.reshape(-1, o))
    sizes, windows = [], []
    for axis, d in enumerate(red):
        if d <= window:
            sizes += [1, d]
            windows.append(d)
            continue
        k = math.ceil(d / window)
        pad = k * window - d
        lo = x.new_zeros(x.shape[:axis] + (pad // 2,) + x.shape[axis + 1:])
        hi = x.new_zeros(x.shape[:axis] + (pad - pad // 2,) + x.shape[axis + 1:])
        x = torch.cat([lo, x, hi], dim=axis)
        sizes += [k, window]
        windows.append(window)
    n = len(red)
    x = x.reshape(sizes + [o]).permute([2 * i + 1 for i in range(n)] + [2 * i for i in range(n)]
                                       + [2 * n])
    counts = [sizes[2 * i] for i in range(n)]
    parts = _sequential_sum(x.reshape(math.prod(windows), math.prod(counts), o))
    return windowed_sum(parts.reshape(counts + [o]), window)


def channel_mean(w):
    """Per-output-channel mean of an OIHW or [out, in] weight, summed with its
    output channels last (HWIO / [in, out]) by ``windowed_sum``."""
    k = w.permute(2, 3, 1, 0) if w.ndim == 4 else w.movedim(0, -1)
    n = math.prod(k.shape[:-1])
    return windowed_sum(k) / torch.full((), float(n), dtype=torch.float32, device=w.device)


def bias_correct(w_orig, w_q):
    """Shift each output channel of ``w_q`` so its mean is ``w_orig``'s."""
    w_orig, w_q = w_orig.float(), w_q.float()
    shape = [-1] + [1] * (w_q.ndim - 1)
    return w_q - channel_mean(w_q).reshape(shape) + channel_mean(w_orig).reshape(shape)


# --------------------------------------------------------- integer serving

def abs_max_scale(amax, bits: int):
    return torch.clamp_min(amax / f32(2.0 ** (bits - 1) - 1.0, amax.device), 1e-8)


def sym_codes(x, scale, bits: int = 8):
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.clamp(torch.round(x.float() / scale), -qmax, qmax).to(torch.int8)


def sym_int8(x, bits: int = 8):
    """Per-output-channel (dim 0) symmetric codes and their scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, xf.ndim)), keepdim=True)
    scale = abs_max_scale(amax, bits)
    return sym_codes(xf, scale, bits), scale.reshape(-1)


def int_matmul(a, b):
    """The exact int32 product of int8 matrices (through float64 on the card,
    exact below 2^53)."""
    if a.device.type == 'cpu':
        return a.to(torch.int32) @ b.to(torch.int32)
    return (a.double() @ b.double()).round().to(torch.int32)


def int_conv(x, w, stride, padding, groups):
    """The exact int32 convolution of int8 codes, channels_last on the card."""
    if x.device.type == 'cpu':
        return F.conv2d(x.to(torch.int32), w.to(torch.int32), None, stride, padding,
                        groups=groups)
    acc = F.conv2d(x.double(), w.double(), None, stride, padding, groups=groups)
    return acc.round().to(torch.int32).contiguous(memory_format=torch.channels_last)


def dequant(acc, alpha, bias, shape):
    out = acc.float() * alpha.view(shape)
    if bias is not None:
        out = out + bias.view(shape)
    return out


def column(v, n, device):
    return f32(v, device).reshape(-1).expand(n).contiguous()
