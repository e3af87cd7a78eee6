"""The arithmetic a model walk (``resnet50.forward``, ``mobilenet_v2.forward``)
asks for, in three kinds:

* ``FloatOps``: float32 convs and linears, each output handed to ``tap(y,
  site)``: pass-through, a statistics recorder, or the simulation's frozen
  fake-quant (``recipes.py``);
* ``ServingOps``: true-int8 serving.  Every conv but the three-channel stem
  and the classifier quantize their input symmetrically (a frozen scale, or
  the input's abs-max while calibrating), multiply int8 codes exactly and
  dequantize with the per-channel weight scale; a ResNet block's input is
  quantized once and its codes feed conv1, the downsample and the residual;
  a downsample's output crosses to the residual as int8 codes;
* ``ShapeOps``: no arithmetic, on the ``meta`` device: the shapes of every
  conv, linear and site, for the work counts of ``yardstick.py``.

A frozen copy of the measured program's plain paths (``models/layers.py``,
``models/resnet.py``), in its order of operations and memory layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import quant as Q


class Codes:
    """int8 codes and the float32 scale they encode."""

    def __init__(self, codes, scale):
        self.codes, self.scale = codes, scale

    def dequant(self):
        return self.codes.float() * self.scale


def _in_ch(P, name, groups):
    return P[f'{name}.weight'].shape[1] * groups


class FloatOps:
    def __init__(self, tap=None):
        self.tap = tap or (lambda y, site: y)

    def conv(self, P, x, name, stride, padding, groups, site, out_codes=False):
        y = F.conv2d(x.float(), P[f'{name}.weight'], P.get(f'{name}.bias'), stride, padding,
                     groups=groups)
        return self.tap(y, site)

    def linear(self, P, x, name, site):
        return self.tap(F.linear(x.float(), P[f'{name}.weight'], P.get(f'{name}.bias')), site)

    def bn(self, P, x, name, site, eps=1e-5):
        """An inference batch norm; a walk passes the ``eps`` its network
        builds the norm with."""
        shape = (1, -1, 1, 1)
        inv = P[f'{name}.weight'] * torch.rsqrt(P[f'{name}.running_var'] + eps)
        y = (x.float() - P[f'{name}.running_mean'].view(shape)) * inv.view(shape) \
            + P[f'{name}.bias'].view(shape)
        return self.tap(y, site)

    def stem_out(self, x, site):
        return x

    def maxpool(self, x, k, s, p, site):
        return self.tap(F.max_pool2d(x, k, s, p), site)

    def block_input(self, x, site):
        return x, x

    def residual(self, out, identity):
        return torch.relu(out + identity)

    def avgpool(self, x, site):
        w = x.shape[2]
        y = F.avg_pool2d(x.float(), (w, w), (1, 1), (0, 0), count_include_pad=True)
        return self.tap(y.to(x.dtype), site)


class ServingOps(FloatOps):
    """``scales``: frozen input scales (site id -> float32 device scalar or
    per-channel vector), or None to calibrate: each input's abs-max then sets
    its scale, and ``absmax[site]`` records it (``site:out`` for a
    downsample's output)."""

    def __init__(self, scales=None):
        super().__init__()
        self.scales = scales
        self.absmax: dict = {}

    def _scale(self, site):
        return None if self.scales is None else self.scales.get(site[0])

    def conv(self, P, x, name, stride, padding, groups, site, out_codes=False):
        w = P[f'{name}.weight']
        bias = P.get(f'{name}.bias')
        in_ch = _in_ch(P, name, groups)
        if in_ch == 3:   # the stem stays a float conv
            return F.conv2d(x.float(), w, bias, stride, padding, groups=groups)
        w_scale = P[f'{name}.w_scale']
        per_group = groups > 1
        if isinstance(x, Codes):
            codes, scale = x.codes, x.scale
        else:
            scale = self._scale(site)
            xf = x.float()
            if scale is None:
                if per_group:
                    n, c, h, wd = xf.shape
                    amax = xf.abs().reshape(n, groups, c // groups, h, wd).amax(
                        dim=(0, 2, 3, 4)).repeat_interleave(c // groups)
                else:
                    amax = xf.abs().amax()
                self.absmax[site[0]] = amax
                scale = Q.abs_max_scale(amax, 8)
            per = scale.view(1, -1, 1, 1) if scale.ndim == 1 else scale
            codes = Q.sym_codes(xf, per, 8)
        o, cg = w.shape[:2]
        scale_out = scale.reshape(groups, cg)[:, 0].repeat_interleave(o // groups) \
            if scale.ndim == 1 else scale
        alpha = Q.column(scale_out * w_scale.float(), o, w.device)
        b = None if bias is None else Q.column(bias, o, w.device)
        if tuple(w.shape[2:]) == (1, 1) and stride == (1, 1) and padding == (0, 0) \
                and groups == 1:
            n, c, h, wd = codes.shape
            a = codes.permute(0, 2, 3, 1).reshape(n * h * wd, c)
            y = Q.dequant(Q.int_matmul(a, w.reshape(o, c).t()), alpha, b, (1, -1))
            y = y.view(n, h, wd, o).permute(0, 3, 1, 2)
        else:
            y = Q.dequant(Q.int_conv(codes, w, stride, padding, groups), alpha, b,
                          (1, -1, 1, 1))
        if out_codes:
            out_site = (site[0] + ':out',) + site[1:]
            s_out = self._scale(out_site)
            if s_out is not None:
                return Codes(Q.sym_codes(y, s_out), s_out)
            if self.scales is None:
                self.absmax[out_site[0]] = y.float().abs().amax()
        return y

    def linear(self, P, x, name, site):
        w, w_scale, bias = P[f'{name}.weight'], P[f'{name}.w_scale'], P.get(f'{name}.bias')
        xf = x.float()
        scale = self._scale(site)
        if scale is None:
            amax = xf.abs().amax()
            self.absmax[site[0]] = amax
            scale = Q.abs_max_scale(amax, 8)
        codes = Q.sym_codes(xf, scale)
        o = w.shape[0]
        alpha = Q.column(scale * w_scale, o, w.device)
        b = None if bias is None else Q.column(bias, o, w.device)
        return Q.dequant(Q.int_matmul(codes.reshape(-1, codes.shape[-1]), w.t()), alpha, b,
                         (1, -1))

    def stem_out(self, x, site):
        s = self._scale(site)
        return x if s is None else Codes(Q.sym_codes(x, s), s)

    def maxpool(self, x, k, s, p, site):
        if isinstance(x, Codes):
            y = F.max_pool2d(x.codes.to(torch.float16), k, s, p)
            return Codes(y.to(torch.int8), x.scale)
        return F.max_pool2d(x, k, s, p)

    def block_input(self, x, site):
        s = self._scale(site)
        if isinstance(x, Codes) or s is None:
            return x, x
        q = Codes(Q.sym_codes(x, s), s)
        return q, q.dequant().to(x.dtype)

    def residual(self, out, identity):
        if isinstance(identity, Codes):
            identity = identity.dequant()
        return torch.relu(out + identity)

    def avgpool(self, x, site):
        w = x.shape[2]
        y = F.avg_pool2d(x.float(), (w, w), (1, 1), (0, 0), count_include_pad=True)
        return y.to(x.dtype)


class ShapeOps(FloatOps):
    """Records, on the ``meta`` device, every conv and linear as
    ``(name, input shape, weight shape, output shape, in_ch)`` and every
    site's output shape."""

    def __init__(self):
        self.layers: list = []
        self.site_shapes: dict = {}
        super().__init__(self._record)

    def _record(self, y, site):
        self.site_shapes[site[0]] = tuple(y.shape)
        return y

    def conv(self, P, x, name, stride, padding, groups, site, out_codes=False):
        y = super().conv(P, x, name, stride, padding, groups, site)
        self.layers.append((name, tuple(x.shape), tuple(P[f'{name}.weight'].shape),
                            tuple(y.shape), _in_ch(P, name, groups)))
        return y

    def linear(self, P, x, name, site):
        y = super().linear(P, x, name, site)
        self.layers.append((name, tuple(x.shape), tuple(P[f'{name}.weight'].shape),
                            tuple(y.shape), x.shape[-1]))
        return y
