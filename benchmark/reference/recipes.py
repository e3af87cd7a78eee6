"""The two recipes worked out again from the float weights and the calibration
images, and the logits they give.

* The simulation's headline recipe (``-pcq_w -pcq_a --qtype int4 -qw int4 -c
  laplace -baa -baw -bcw -sm use``): 4-bit per-channel weights with per-channel
  bit allocation (8 bits for the three-channel stem, the classifier and the
  convs a walk names in ``EIGHT_BIT_WEIGHTS``) and
  bias correction; activation statistics of the calibration images; per-site
  frozen (delta, offset, qmax): Laplace clipping with bit allocation at the
  4-bit sites, the stem's output at 8 bits, min/max grids at the pools and
  the classifier; each site's output fake-quantized on its grid.
* Integer serving (``--qtype int8 -qw int8 --serving_int8``): per-tensor 8-bit
  weights (the original CUDA kernel's min/max grid), then per-channel
  symmetric int8 codes; each conv input's frozen scale is its largest
  abs-max over the calibration batches over 127.

``control=True`` computes the same in the precisions just below the
configuration's: float convs and matmuls in TF32, and the float weights read
in bfloat16.  A frozen copy of the measured program's plain paths
(``engine/engine.py``, ``engine/qparams.py``, ``engine/policy.py``,
``calib/calibrator.py``); see ``quant.py``.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from . import quant as Q
from .layers import FloatOps, ServingOps

# the tags of the headline recipe: (bits, clipping, per-channel stats,
# bit allocation, stats kind)
SIM_TAGS = {
    'activation': (4, 'laplace', True, True, 'mean'),
    'default': (8, 'laplace', True, True, 'mean'),     # average pools
    'activation_pooling': (8, 'no', False, False, 'mean'),
    'activation_classifier': (8, 'no', False, False, 'max'),
    'ignored': (8, 'no', False, False, 'mean'),        # the stem's output
}
IGNORED = ('conv0_activation',)
# the program's ``QuantPolicy`` fields of the two recipes this module works out
RECIPES = {
    'sim': {'qtype': 'int4', 'qweight': 'int4', 'pcq_weights': True, 'pcq_act': True,
            'clipping': 'laplace', 'bit_alloc_act': True, 'bit_alloc_weight': True,
            'bias_corr_weight': True},
    'serving': {'qtype': 'int8', 'qweight': 'int8'},
}


def require(traffic: dict):
    """Fail unless ``traffic``'s recipe is the one this reference implements
    for its path: a traffic mix with another recipe needs a reference of its
    own."""
    want = RECIPES.get(traffic['path'])
    if traffic['recipe'] != want:
        raise ValueError(f"the reference implements the {traffic['path']!r} recipe {want}, "
                         f"not {traffic['recipe']}")


def model(arch: str):
    return importlib.import_module(f'{__package__}.{arch}')


@contextlib.contextmanager
def precision(control: bool):
    """TF32 off (the configuration), or on (the control), for float convs and
    matmuls inside."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = control
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def weights_read(P, control: bool):
    """The float weights as the recipe reads them (bfloat16 for the control)."""
    if not control:
        return P
    return {k: v.to(torch.bfloat16).float() if _is_weight(k, v) else v for k, v in P.items()}


def _is_weight(k, v):
    return k.endswith('.weight') and v.ndim in (2, 4)


def _nchw(images, device):
    return torch.as_tensor(images, dtype=torch.float32).to(device).permute(0, 3, 1, 2)


# ------------------------------------------------------------- simulation

def eight_bit_weights(arch) -> tuple:
    """The module paths whose weights the walk of ``arch`` keeps at 8 bits
    (its ``EIGHT_BIT_WEIGHTS``, matched as substrings of a weight's path, as
    the program's ``ModelMeta.eight_bit_weight_names``); none if it declares
    none."""
    return tuple(getattr(model(arch), 'EIGHT_BIT_WEIGHTS', ()))


def sim_weights(arch, P):
    """4-bit per-channel weights with bit allocation, bias-corrected; the
    three-channel stem, the classifier and the walk's ``EIGHT_BIT_WEIGHTS``
    at 8 bits."""
    eight_bit = eight_bit_weights(arch)
    out = dict(P)
    for k, w in P.items():
        if not _is_weight(k, w):
            continue
        path = k[:-len('.weight')]
        bits = 8 if (w.ndim == 4 and w.shape[1] == 3) or w.ndim == 2 \
            or any(n in path for n in eight_bit) else 4
        t = w.contiguous()
        s = Q.channel_stats(t, ['min', 'max'], axis=0)
        if bits <= 4:
            std = Q.channel_stats(t, ['std'], axis=0)['std']
            qmax = Q.qmax_for_bits(Q.bits_alloc_fixed_target(std, bits))
        else:
            qmax = 2.0 ** bits - 1.0
        w_q = Q.fake_quant(t, s['max'] - s['min'], s['min'], qmax, axis=0)
        out[k] = Q.bias_correct(w, w_q).to(w.dtype)
    return out


def collect(arch, P, batches, device, control=False):
    """Per-site statistics over the calibration batches, aggregated as the
    calibrator does: per batch min/max/mean/std/b per tensor and per channel,
    then the min, mean and max over batches (float64 on the host, stored as
    float32)."""
    agg: dict = {}

    def tap(y, site):
        xf = y.float()
        entry = {f'scalar/{k}': v for k, v in Q.tensor_stats(xf, ['std', 'mean', 'b']).items()}
        entry.update({f'scalar/{k}': v for k, v in Q.tensor_stats(xf, ['min', 'max']).items()})
        if xf.ndim == 4 and (xf.shape[2] > 1 or xf.shape[3] > 1):
            pc = Q.channel_stats(xf, ['std', 'mean', 'b'])
            pc.update(Q.channel_stats(xf, ['min', 'max']))
            entry.update({f'channel/{k}': v for k, v in pc.items()})
        for stat, v in entry.items():
            agg.setdefault(site[0], {}).setdefault(stat, []).append(
                v.detach().float().cpu().numpy().astype(np.float64))
        return y

    m = model(arch)
    with precision(control), torch.no_grad():
        for images in batches:
            m.forward(P, _nchw(images, device), FloatOps(tap))
    summary = {}
    for site, stats in agg.items():
        entry = summary.setdefault(site, {})
        for stat, vals in stats.items():
            space, name = stat.split('/', 1)
            entry[f'{space}/min_{name}'] = np.minimum.reduce(vals).astype(np.float32)
            total = vals[0].copy()
            for v in vals[1:]:
                total += v
            entry[f'{space}/mean_{name}'] = (total / len(vals)).astype(np.float32)
            entry[f'{space}/max_{name}'] = np.maximum.reduce(vals).astype(np.float32)
    return summary


def freeze(arch, summary, input_size, device):
    """{site id: (delta, offset, qmax, per_channel)} of every site."""
    m = model(arch)
    ops = _shapes(arch, input_size)
    out = {}
    for site in m.sites():
        sid, tag, half = site
        if sid not in ops.site_shapes:
            continue
        tag = 'ignored' if sid in IGNORED else tag
        bits, clipping, per_channel, alloc, kind = SIM_TAGS[tag]
        shape = ops.site_shapes[sid]
        spatial = len(shape) == 4 and (shape[2] > 1 or shape[3] > 1)
        entry = summary[sid]
        space = 'channel' if per_channel and any(k.startswith('channel/') for k in entry) \
            else 'scalar'
        st = {k[len(space) + 1:]: Q.f32(v, device) for k, v in entry.items()
              if k.startswith(space + '/')}
        qmax = Q.f32(2.0 ** bits - 1.0, device)
        if clipping == 'laplace':
            mn, mx, mean, b = st['mean_min'], st['mean_max'], st['mean_mean'], st['mean_b']
            pc = per_channel and spatial and mn.ndim > 0 and mn.shape[0] > 1
            alloc_bits = Q.bits_alloc_fixed_target(st['mean_std'], bits) \
                if alloc and pc and bits <= 4 else None
            alpha = Q.alpha_laplace(b, alloc_bits if alloc_bits is not None else bits, half)
            delta, offset = Q.alpha_to_delta_offset(alpha, mx, mn, mean, half)
            if pc and alloc_bits is not None:
                qmax = Q.qmax_for_bits(alloc_bits)
            out[sid] = (delta, offset, qmax, pc)
        else:
            kmin, kmax = ('mean', 'mean') if kind == 'mean' else ('min', 'max')
            delta, offset = Q.minmax_delta_offset(st[f'{kmin}_min'], st[f'{kmax}_max'], half)
            out[sid] = (delta, offset, qmax, False)
    return out


def sim_logits(arch, pq, qparams, images, device, control=False):
    def tap(y, site):
        delta, offset, qmax, pc = qparams[site[0]]
        return Q.fake_quant(y, delta, offset, qmax, axis=1 if pc else None).to(y.dtype)

    with precision(control), torch.no_grad():
        return model(arch).forward(pq, _nchw(images, device), FloatOps(tap))


# ---------------------------------------------------------------- serving

def serving_weights(P):
    """Per-tensor 8-bit weights (min/max grid), then per-channel int8 codes
    and a ``w_scale`` per conv and linear; the three-channel stem stays a
    float conv."""
    pq = dict(P)
    for k, w in P.items():
        if _is_weight(k, w):
            s = Q.tensor_stats(w, ['min', 'max'])
            delta, offset = Q.minmax_delta_offset(s['min'], s['max'], False)
            pq[k] = Q.fake_quant_minmax(w, delta, offset, 8).to(w.dtype)
    ps = dict(pq)
    for k, w in pq.items():
        if not _is_weight(k, w) or (w.ndim == 4 and w.shape[1] == 3):
            continue
        codes, scale = Q.sym_int8(w.float(), 8)
        ps[k] = codes.contiguous(memory_format=torch.channels_last) if codes.ndim == 4 \
            else codes
        ps[k[:-len('.weight')] + '.w_scale'] = scale
    return ps


def serving_scales(arch, ps, batches, device, control=False):
    """{site: scale}: each input's largest abs-max over the batches / 127,
    a float (a float32 vector for a depthwise conv's per-channel scales)."""
    agg: dict = {}
    m = model(arch)
    with precision(control), torch.no_grad():
        for images in batches:
            ops = ServingOps(None)
            m.forward(ps, _nchw(images, device), ops)
            for site, v in ops.absmax.items():
                agg.setdefault(site, []).append(v.double().cpu().numpy())
    out = {}
    for site, vals in agg.items():
        val = np.maximum(np.maximum.reduce(vals) / 127.0, 1e-8)
        out[site] = float(val) if np.ndim(val) == 0 else val.astype(np.float32)
    return out


def serving_logits(arch, ps, scales, images, device, control=False):
    dev_scales = {k: Q.f32(v, device) for k, v in scales.items()}
    with precision(control), torch.no_grad():
        return model(arch).forward(ps, _nchw(images, device), ServingOps(dev_scales))


# ------------------------------------------------------------------ shapes

def _shapes(arch, input_size, batch: int = 1):
    """``ShapeOps`` after a walk of ``arch`` on the ``meta`` device."""
    from .layers import ShapeOps
    m = model(arch)
    P = meta_params(arch)
    ops = ShapeOps()
    x = torch.empty((batch, 3, input_size, input_size), device='meta')
    m.forward(P, x, ops)
    return ops


def meta_params(arch):
    """The float parameters of ``arch`` as ``meta`` tensors, by name."""
    return {k: torch.empty(shape, device='meta') for k, shape in model(arch).param_shapes().items()}
