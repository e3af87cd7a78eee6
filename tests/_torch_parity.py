"""Shared set-up for the port's parity tests: one architecture with the same
BN-folded weights and the same input in the JAX package and in the port."""

from unittest import mock

import numpy as np
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine import QuantEngine as JEngine
from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
from cnn_quantization_tpu.engine.context import QuantizeContext as JQuantizeContext
from cnn_quantization_tpu.engine.qparams import discover_sites as j_discover_sites
from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.utils import torch_import
from cnn_quantization_tpu.utils.torch_import import import_arch

from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy, TapContext
from cnn_quantization_tpu_torch.engine.context import QuantizeContext
from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QBatchNorm, QConv, QLinear
from cnn_quantization_tpu_torch.utils.device import nhwc_to_nchw
from cnn_quantization_tpu_torch.utils.flax_params import state_dict_from_flax

POLICIES = {
    'naive_w4a4': dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True),
    'headline': dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                     clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                     bias_corr_weight=True),
}


def site_table(sites, nhwc):
    """[(id, tag, half_range, kind, NCHW shape)] of a ``discover_sites`` result;
    ``nhwc`` says the shapes are the JAX package's."""
    rows = []
    for s, shape in sites:
        shape = tuple(shape)
        if nhwc and len(shape) == 4:
            shape = (shape[0], shape[3], shape[1], shape[2])
        rows.append((s.id, s.tag, s.half_range, s.kind, shape))
    return rows


def flatten_inputs_at(arch, size):
    """The JAX importer's ``FLATTEN_INPUTS`` entry of VGG and AlexNet (the
    (C, H, W) map their first classifier flattens) at a ``size`` x ``size``
    input; the package's own table holds the 224x224 maps."""
    if arch.startswith('vgg'):
        return {arch.replace('_bn', ''): {'classifier_0': (512, size // 32, size // 32)}}
    if arch == 'alexnet':
        h = (size + 4 - 11) // 4 + 1
        for _ in range(3):
            h = (h - 3) // 2 + 1
        return {'alexnet': {'classifier_1': (256, h, h)}}
    return {}


def import_params(arch, state, fold_bn, size=None):
    """JAX ``import_arch`` of a torchvision-style state built for a ``size``
    input (None: 224, or 299 for Inception-v3)."""
    with mock.patch.dict(torch_import.FLATTEN_INPUTS,
                         flatten_inputs_at(arch, size) if size else {}):
        return import_arch(arch, state, fold_bn=fold_bn)


def torchvision_like_state(arch, seed=12345, size=None):
    """An unfolded torchvision-style checkpoint, as the reference parity tests
    build it: kaiming fan-out convs, randomized BN (their ``randomize_bn``),
    torch's default uniform init for the classifier.  ``size`` is the input
    the model is built for (it sets VGG's and AlexNet's first classifier)."""
    model, _ = build_model(arch, fold_bn=False, device='cpu', input_size=size)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, QConv):
                torch.nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                              nonlinearity='relu', generator=g)
            elif isinstance(m, QBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=g) * 0.05)
            elif isinstance(m, QLinear):
                bound = m.weight.shape[1] ** -0.5
                m.weight.uniform_(-bound, bound, generator=g)
                m.bias.uniform_(-bound, bound, generator=g)
    return {k: v.numpy() for k, v in model.state_dict().items()}


class Pair:
    """The same arch, weights and input in both packages.  BN is folded as the
    registry folds the arch (``fold_bn=None``; every 'resnet' arch, so not
    resnext or mobilenet_v2) or as ``fold_bn`` says; ``dtype`` is the type the
    activations travel in."""

    def __init__(self, arch, size, batch=2, fold_bn=None, dtype='float32'):
        self.arch, self.size = arch, size
        kw = {} if dtype == 'float32' else {'dtype': dtype}   # mobilenet_v2 takes none
        self.j_model, self.j_meta = j_build_model(arch, fold_bn=fold_bn, **kw)
        fold_bn = self.j_meta.fold_bn
        self.j_params = import_params(arch, torchvision_like_state(arch, size=size), fold_bn,
                                      size)
        self.model, self.meta = build_model(arch, fold_bn=fold_bn, device='cpu',
                                            input_size=size, **kw)
        self.model.load_state_dict(state_dict_from_flax(self.j_params, arch), strict=True)
        self.params = dict(self.model.state_dict())
        self.sites = [s for s, _ in discover_sites(self.model, (1, 3, size, size))]
        self.x = (np.random.RandomState(3).rand(batch, size, size, 3).astype(np.float32)
                  * 2 - 1)

    def logits(self, policy_kw, eager=False):
        """(port logits, JAX logits) of the quantized forward.  The JAX side
        runs jitted, as its CLI does, or with ``eager`` under
        ``jax.disable_jit()``: its weight pass and forward op by op, as the
        port runs them (XLA's jit multiplies by reciprocals of constants,
        which flips codes at rounding ties)."""
        j_eng = JEngine(self.j_model, JPolicy(arch=self.arch, **policy_kw), self.j_meta)
        if eager:
            with jax.disable_jit():
                want, _ = j_eng.make_forward()(j_eng.quantize_params(self.j_params), None,
                                               jnp.asarray(self.x))
        else:
            j_pq = j_eng.quantize_params(self.j_params)
            want, _ = j_eng.jit_forward()(j_pq, None, jnp.asarray(self.x))
        eng = QuantEngine(self.model, QuantPolicy(arch=self.arch, **policy_kw), self.meta)
        got, _ = eng.make_forward()(eng.quantize_params(self.params), None, self.x)
        return got.numpy(), np.asarray(want)

    def teacher_forced(self, policy_kw, eager=False):
        """Relative error of each site's quantized output, both quantizers fed
        the same pre-quantization tensor (the float model's, per site), so
        no error compounds from site to site.  The JAX taps run jitted, or
        with ``eager`` under ``jax.disable_jit()``."""
        cap = CaptureContext()
        with torch.no_grad():
            torch.func.functional_call(self.model, self.params,
                                       (nhwc_to_nchw(self.x, 'cpu'), cap))
        acts = {k: (v.permute(0, 2, 3, 1) if v.ndim == 4 else v).contiguous().numpy()
                for k, v in cap.acts.items()}
        sites = j_discover_sites(self.j_model, self.x.shape)
        j_ctx = JQuantizeContext(JPolicy(arch=self.arch, **policy_kw))

        def taps(a):
            return {s.id: j_ctx.tap(a[s.id], s) for s, _ in sites}

        if eager:
            with jax.disable_jit():
                want = jax.device_get(taps(acts))
        else:
            want = jax.device_get(jax.jit(taps)(acts))
        ctx = QuantizeContext(QuantPolicy(arch=self.arch, **policy_kw))
        rels = {}
        for site, _shape in sites:
            got = ctx.tap(cap.acts[site.id], site)
            got = (got.permute(0, 2, 3, 1) if got.ndim == 4 else got).numpy()
            w = np.asarray(want[site.id])
            rels[site.id] = np.linalg.norm(got - w) / (np.linalg.norm(w) + 1e-12)
        return rels


class CaptureContext(TapContext):
    """Records every site's float tensor and passes it on unchanged."""

    def __init__(self):
        self.acts = {}

    def tap(self, x, site):
        self.acts[site.id] = x
        return x
