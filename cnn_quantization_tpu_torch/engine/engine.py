"""QuantEngine: weight quantization and quantized forward passes.

Port of ``cnn_quantization_tpu/engine/engine.py`` (the reference's
``QuantizationManagerInference``, i_q_m.py:286-393).  Parameters are a ``state_dict``
(name -> tensor) in torchvision naming with OIHW conv and [out, in] linear
weights; a forward runs the model's module tree on them with
``torch.func.functional_call``, the counterpart of ``model.apply``.  A
serving-prepared tree (``prepare_serving_params``) holds int8 codes under the
weight names plus a ``<module>.w_scale`` entry each.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..ops import bias_corr
from ..ops.aciq import ALPHA_LAPLACE
from ..ops.kernels.int_conv import s2d_stem_kernel
from ..ops.kernels.int_matmul import quantize_sym_int8
from ..ops.quantizer import quantize_weight
from ..ops.stats import global_over
from ..utils import counters, spans
from ..utils.device import as_f32, nhwc_to_nchw
from .context import CollectContext, QuantizeContext, ServingInt8Context, TapContext
from .policy import QuantPolicy, parse_qtype_bits


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static per-architecture facts the engine needs."""
    arch: str
    fold_bn: bool = True
    input_size: int = 224
    # module paths whose weights stay 8-bit by name (inception stem,
    # inference_quantization_manager.py:360-362)
    eight_bit_weight_names: tuple[str, ...] = ()


def _weight_names(params: Mapping[str, torch.Tensor]):
    """Conv (4-D) and linear (2-D) ``*.weight`` entries; BN weights are 1-D."""
    return [k for k, v in params.items()
            if k.endswith('.weight') and v.ndim in (2, 4)]


class QuantEngine:
    def __init__(self, model: torch.nn.Module, policy: QuantPolicy, meta: ModelMeta,
                 stats: Mapping[str, Any] | None = None,
                 ignore_ids: tuple[str, ...] = ()):
        self.model = model
        self.policy = policy
        self.meta = meta
        self.stats = stats
        self.ignore_ids = tuple(ignore_ids)
        # frozen serving scales on the device by their values, and the
        # captured serving forwards by input shape and settings (_graph_forward)
        self._device_scales: dict[tuple, dict] = {}
        self._graphs: dict[tuple, _ServingGraph] = {}

    # ------------------------------------------------------------------
    # Weight quantization pass (reference quantize_model, i_q_m.py:352-393)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def quantize_params(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A new state dict with every conv/linear weight fake-quantized per
        the policy (one fake-quant kernel launch per weight)."""
        with spans.span('engine.quantize_params', counts={'weights': 0}) as top:
            configs = self.policy.tag_configs()
            out = dict(params)
            if not configs:
                return out
            for name in _weight_names(params):
                kernel = params[name]
                path = name[:-len('.weight')]
                if kernel.ndim == 4:
                    cfg = configs['weight']
                    if cfg is not None:
                        in_ch = kernel.shape[1]  # OIHW
                        name8 = any(n in path for n in self.meta.eight_bit_weight_names)
                        if in_ch == 3 or name8:
                            # first layer / inception stem stay 8-bit
                            cfg = dataclasses.replace(cfg, num_bits=8)
                else:
                    out_ch = kernel.shape[0]  # [out, in]
                    cfg = configs['weight_classifier' if out_ch == 1000 else 'weight']
                if cfg is None:
                    continue
                w_in = kernel
                if self.policy.rho_weight is not None:
                    # fp32 ratio clip ahead of weight quantization (the reference's
                    # weights_clipper, live here; clipping_manager.py:45-62); the
                    # corrections below still target the ORIGINAL fp32 moments
                    from ..ops.clippers import ratio_clip
                    w_in = ratio_clip(kernel, self.policy.rho_weight)
                with spans.span('weight.grid'):
                    w_q, _ = quantize_weight(w_in, cfg, out_axis=0)
                if self.policy.var_corr_weight or self.policy.bias_corr_weight:
                    with spans.span('weight.bias_corr'):
                        w_q = bias_corr.weight_correction(
                            kernel, w_q, out_axis=0,
                            bias_corr=self.policy.bias_corr_weight,
                            var_corr=self.policy.var_corr_weight)
                out[name] = w_q.to(kernel.dtype)
                top.counts['weights'] += 1
            return out

    # ------------------------------------------------------------------
    # Step functions
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _serving_bits(self) -> tuple[int, int]:
        """(activation bits, weight bits) of the serving grid: the policy's
        widths clamped to 8; the codes travel as int8 either way."""
        act = parse_qtype_bits(self.policy.qtype) if self.policy.qtype else 8
        weight = (parse_qtype_bits(self.policy.qweight)
                  if self.policy.qweight not in (None, 'f32') else 8)
        return min(act, 8), min(weight, 8)

    def make_forward(self, quantized: bool | str = True, qparams=None,
                     act_scales=None, packed: bool | tuple = False, mesh=None) -> Callable:
        """f(params, stats, images) -> (logits, aux).  ``images`` are NHWC, as
        the JAX package takes them; the model runs them as an NCHW
        channels_last view on its device.  ``stats`` is the calibration dict
        or None; ``qparams`` (from ``freeze_qparams``) enables the frozen path
        per site.  ``quantized='serving_int8'`` runs the true-integer path;
        ``act_scales`` (from ``freeze_serving_scales``) freezes its activation
        scales, removing the per-conv dynamic abs-max pass.  ``packed`` (True,
        or a tuple of 1-based stages) asks for the W4A4 packed trunk: the 1x1
        convs of a Bottleneck ResNet as int4-packed GEMMs, block boundaries two
        codes to a byte.  It engages only with scales frozen with
        ``packed=True`` and needs activations of at most 4 bits: the packed
        epilogue clamps codes to +-7 whatever the grid.

        ``mesh`` (``parallel/mesh.Mesh``) runs the forward as one rank of a
        (data, model) grid: ``images`` are this rank's slice of the batch and
        ``params`` its shard (``parallel/mesh.shard_params``); activation
        statistics reduce over the data group, sharded convs and linears
        gather their output channels over the model group.  The packed trunk
        takes no model axis: its int4 codes pack in groups of 256 along K,
        which a channel slice would cut.

        On the card, a serving forward with frozen scales and no mesh runs
        as a CUDA graph (``_ServingGraph``): its first call at an input
        shape captures the forward, later calls copy the images into the
        graph's input and replay it, a fresh copy of the logits each call.
        A graph is kept on the engine per (images' shape and dtype,
        ``packed``, the TF32 and cuDNN settings) for the engine's life, with
        the private memory pool that holds its activations, and replays only
        for the params dict, the tensor objects it held at capture and the
        same frozen values; anything else captures anew in its place.  Every
        other forward runs module by module.  The returned forward's
        ``eager`` attribute is the same forward run module by module, for
        callers that watch the Python forward (module hooks, patched kernel
        wrappers), which a replay does not run; its ``context(stats)`` makes
        the context each of its forwards runs."""
        serving = quantized == 'serving_int8'
        if serving:
            act_bits, weight_bits = self._serving_bits()
            if packed and act_bits > 4:
                raise ValueError(f'packed serving stores 4-bit codes; the policy asks for '
                                 f'{act_bits}-bit activations (qtype={self.policy.qtype!r})')
            if packed and mesh is not None and mesh.model > 1:
                raise ValueError('packed serving cannot split output channels over a model '
                                 'axis: the int4 codes pack in groups of 256 along K')
            # frozen scales live on the device from here on: no host-to-device
            # copy per forward
            scales = self._scales_on_device(act_scales)

        def context(stats):
            if serving:
                return ServingInt8Context(act_scales=scales, act_bits=act_bits,
                                          weight_bits=weight_bits, packed=packed)
            if quantized and self.policy.qtype is not None:
                return QuantizeContext(self.policy, stats=stats,
                                       ignore_ids=self.ignore_ids, qparams=qparams)
            return TapContext()

        @torch.no_grad()
        def fwd(params, stats, images):
            return _run(self.model, params, images, context(stats), self.device, mesh)

        eager = _forward_span(fwd)
        eager.eager, eager.context = eager, context
        device = self.device
        if not (serving and act_scales and mesh is None and device.type == 'cuda'):
            return eager
        graphs, model = self._graphs, self.model

        def serve(params, x):
            return _apply(model, params, x, context(None))

        @torch.no_grad()
        def replayed(params, stats, images):
            return _graph_forward(graphs, serve, params, scales, images, packed, device)

        graphed = _forward_span(replayed)
        graphed.eager, graphed.context = eager, context
        return graphed

    def _scales_on_device(self, act_scales) -> dict:
        """``act_scales`` as float32 tensors on the device, made once per
        distinct set of frozen values, so that every ``make_forward`` of one
        set hands its forwards the same tensors: a captured graph reads them
        by address.  Scales given as tensors go to the device anew."""
        if not act_scales:
            return {}
        values = _scales_values(act_scales)
        scales = self._device_scales.get(values) if values is not None else None
        if scales is None:
            scales = {k: as_f32(v, self.device) for k, v in act_scales.items()}
            if values is not None:
                self._device_scales[values] = scales
        return scales

    @torch.no_grad()
    def prepare_serving_params(self, params_q: Mapping[str, torch.Tensor], *,
                               s2d_stem: bool = False) -> dict[str, torch.Tensor]:
        """Offline weight quantization for true-int8 serving: conv and linear
        weights become int8 codes (same shape, a quarter of the bytes; 4-D
        codes in channels_last memory, K contiguous for the kernels) with a
        per-output-channel ``<module>.w_scale`` entry, so the serving forward
        quantizes no weight.  Numerics equal the in-call quantization (the
        same ``quantize_sym_int8`` call).  Convs quantize at
        ``min(qweight bits, 8)``, 8 bits for ``eight_bit_weight_names``;
        linears always at 8.

        The first conv (in_ch == 3) stays float and runs as the float conv.
        ``s2d_stem=True`` (BN-folded ResNet 7x7/2 stems, even input sizes)
        instead space-to-depth transforms it to an equivalent [O, 12, 4, 4]
        stride-1 kernel quantized to int8 (``s2d_stem_kernel``)."""
        with spans.span('engine.prepare_serving_params', counts={'weights': 0}) as top:
            _, wb = self._serving_bits()
            out = dict(params_q)
            for name in _weight_names(params_q):
                kernel = params_q[name]
                path = name[:-len('.weight')]
                if kernel.ndim == 4:
                    if kernel.shape[1] == 3:
                        if not (s2d_stem and self.meta.fold_bn
                                and tuple(kernel.shape[1:]) == (3, 7, 7)):
                            continue  # the float first conv
                        kernel, bits = s2d_stem_kernel(kernel.float()), 8
                    else:
                        name8 = any(n in path for n in self.meta.eight_bit_weight_names)
                        bits = 8 if name8 else wb
                else:
                    bits = 8  # linear/classifier weights stay 8-bit (policy)
                codes, scale = quantize_sym_int8(kernel.float(), axis=0, bits=bits)
                if codes.ndim == 4:
                    codes = codes.contiguous(memory_format=torch.channels_last)
                out[name] = codes
                out[f'{path}.w_scale'] = scale
                top.counts['weights'] += 1
            return out

    def freeze_serving_scales(self, params_q, batches, *, max_batches: int = 4,
                              mode: str = 'max', percentile: float = 99.99,
                              packed: bool = False) -> dict:
        """Calibrate frozen serving-int8 activation scales over a few batches.
        ``mode`` sets the per-site scale from the recorded input statistics:

          'max'        - max over batches of abs-max (the grid covers every
                         calibration value; one outlier stretches it);
          'percentile' - max over batches of the |x| ``percentile`` (any
                         value, used exactly): outlier tails are clipped;
          'aciq'       - ACIQ-Laplace optimal clip for the serving bit width,
                         alpha = c_bits * E|x|, never wider than abs-max.

        Returns {site id: float, or a float32 ``[in_ch]`` vector for grouped
        conv inputs}; ``linear*``, ``conv0_*`` and ``*:out`` sites always use
        the full int8 grid.  ``packed=True`` also emits, for every ``*:out``
        site (a downsample conv's identity codes), a ``<site>:out:packed``
        scale on the activation-bit grid, which the packed trunk stores those
        codes at.  The distinct key keeps the plain path's full-int8 identity
        grid and makes provenance structural: the packed trunk requires the
        ``:out:packed`` keys, which only this call with ``packed=True`` emits."""
        if mode not in ('max', 'percentile', 'aciq'):
            raise ValueError(f'unknown serving calibration mode {mode!r}')
        with spans.span('engine.freeze_serving_scales', counts={'images': 0}) as top:
            act_bits, weight_bits = self._serving_bits()
            agg: dict[str, dict[str, list]] = {}
            with torch.no_grad():
                for i, (images, _) in enumerate(batches):
                    if i >= max_batches:
                        break
                    with spans.span('calib.batch'):
                        ctx = ServingInt8Context(act_bits=act_bits, weight_bits=weight_bits,
                                                 calibrate=True, percentile=percentile)
                        x = nhwc_to_nchw(images, self.device)
                        torch.func.functional_call(self.model, params_q, (x, ctx))
                        for key, v in ctx.finalize().items():
                            if '/' not in key:
                                continue
                            site_id, stat = key.rsplit('/', 1)
                            # a scalar for per-tensor sites, a channel vector for
                            # grouped conv inputs
                            agg.setdefault(site_id, {}).setdefault(stat, []).append(
                                v.double().cpu().numpy())
                    top.counts['images'] += images.shape[0]

            frozen: dict[str, Any] = {}
            for site_id, stats in agg.items():
                # linear/classifier inputs always quantize on the full int8 grid
                # (QLinear), ':out' sites (downsample identity codes) likewise,
                # and conv0 (the in_ch == 3 stem) is the reference's automatic
                # 8-bit exception for int4 runs (i_q_m.py:336-338)
                bits = (8 if site_id.startswith(('linear', 'conv0_')) or site_id.endswith(':out')
                        else act_bits)
                qmax = 2.0 ** (bits - 1) - 1.0
                # every reduction is elementwise, so vector stats freeze to vectors
                absmax = np.maximum.reduce(stats['absmax'])
                if mode == 'max':
                    clip = absmax
                elif mode == 'percentile':
                    clip = np.maximum.reduce(stats['pq'])
                else:
                    clip = np.minimum(ALPHA_LAPLACE[bits] * np.mean(stats['b'], axis=0), absmax)
                targets = {site_id: qmax}
                if packed and site_id.endswith(':out'):
                    targets[site_id + ':packed'] = 2.0 ** (act_bits - 1) - 1.0
                for key, q in targets.items():
                    val = np.maximum(clip / q, 1e-8)
                    frozen[key] = float(val) if np.ndim(val) == 0 else val.astype(np.float32)
            top.counts['sites'] = len(frozen)
            return frozen

    def freeze_qparams(self, stats, input_shape=None):
        """Per-site (delta, offset, qmax) from a stats artifact, as tensors on
        the model's device (engine/qparams.py).  ``input_shape`` is NHWC, as
        in the JAX package."""
        from .qparams import discover_sites, freeze_qparams
        if input_shape is None:
            s = self.meta.input_size
            input_shape = (1, s, s, 3)
        n, h, w, c = input_shape
        with spans.span('engine.freeze_qparams') as top:
            sites = discover_sites(self.model, (n, c, h, w))
            out = freeze_qparams(self.policy, stats, sites, self.ignore_ids,
                                 device=self.device)
            top.counts = {'sites': len(out)}
        return out

    def make_collect(self, per_channel: bool | None = None,
                     batch_avg: bool = False,
                     err_bits: int | None = None, mesh=None) -> Callable:
        """f(params, x) -> (logits, stats_batch) for calibration.  ``err_bits``
        also collects per-prior quantization-error columns at that width.
        With a ``mesh``, ``x`` is this rank's slice of the batch and the
        statistics are the global batch's (reduced over the data group)."""
        if per_channel is None:
            per_channel = self.policy.pcq_act

        @torch.no_grad()
        def fwd(params, images):
            ctx = CollectContext(per_channel=per_channel, batch_avg=batch_avg,
                                 err_bits=err_bits)
            return _run(self.model, params, images, ctx, self.device, mesh)

        return _forward_span(fwd)


def _forward_span(fwd):
    """``fwd`` as one ``engine.forward`` span, which carries the counters
    that moved during it (``utils/counters.since``)."""
    def call(*args):
        with spans.span('engine.forward') as s:
            before = counters.snapshot()
            out = fwd(*args)
            s.counts = counters.since(before)
        return out

    return call


def _run(model, params, images, ctx, device, mesh=None):
    """(logits, ctx.finalize()) of one forward of ``model`` on ``params``
    and NHWC ``images``; under a ``mesh`` the context carries this rank's
    groups and the activation statistics reduce over the data group."""
    if mesh is not None:
        # a data axis of one rank reduces nothing: its statistics stay the
        # single-device arithmetic
        ctx.data_group = mesh.data_group if mesh.data > 1 else None
        ctx.model_group = mesh.model_group
    return _apply(model, params, nhwc_to_nchw(images, device), ctx)


def _apply(model, params, x, ctx):
    """(logits, ctx.finalize()) of ``model`` on ``params`` and the NCHW
    ``x`` already on its device."""
    with global_over(ctx.data_group):
        logits = torch.func.functional_call(model, params, (x, ctx))
    return logits, ctx.finalize()


def _scales_values(act_scales) -> tuple | None:
    """Frozen serving scales as a hashable tuple of (site, shape, float32
    bytes), the values ``as_f32`` puts on the device; None where a scale is a
    tensor."""
    out = []
    for site, v in act_scales.items():
        if isinstance(v, torch.Tensor):
            return None
        v = np.asarray(v, np.float32)
        out.append((site, v.shape, v.tobytes()))
    return tuple(out)


def _graph_forward(graphs: dict, serve, params, scales, images, packed, device):
    """(logits, aux) of the serving forward ``serve(params, x)`` of NHWC
    ``images``, replayed from the graph ``graphs`` holds for the images'
    shape and dtype, ``packed`` and the float settings where that graph
    ``serves`` these params and scales, else from a graph captured now in
    its place.  The settings that choose the float stem's and classifier's
    arithmetic (TF32, cuDNN's algorithm choice) are baked in at capture."""
    key = (images.shape, images.dtype, packed, torch.backends.cudnn.allow_tf32,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.backends.cuda.matmul.allow_tf32)
    graph = graphs.get(key)
    if graph is None or not graph.serves(params, scales):
        graphs[key] = graph = _ServingGraph(serve, params, scales, images, device)
        counters.add('serving_graph.captures')
    else:
        nhwc_to_nchw(images, device, out=graph.x)
        counters.add('serving_graph.replays')
    return graph.replay()


class _ServingGraph:
    """One frozen serving forward captured into a CUDA graph at one input
    shape, and everything the graph reads, held so that no address it baked
    in is freed under it: the params dict and the tensors it held, the
    device scales, the static NHWC input ``x``.

    The capture follows ``torch.cuda.graph``: one forward run module by
    module on a side stream (lazy set-up such as cuDNN's plans happens
    outside the capture), then the capture of a second, which launches
    nothing.  A replay runs no kernel wrapper, so it adds to
    ``utils/counters`` what the capture counted; the warm-up's and the
    capture's counts are taken back, so the capturing call counts one
    forward, the one its first replay runs.  A capture that fails raises.

    A replay reads the params tensors by address: writing new values into
    them in place is seen, a tensor whose storage is swapped in place
    (``set_``) is not."""

    def __init__(self, serve, params, scales, images, device):
        self.params, self.tensors, self.scales = params, tuple(params.values()), scales
        self.x = torch.empty(tuple(images.shape), dtype=torch.float32, device=device)
        x = nhwc_to_nchw(images, device, out=self.x)
        before = counters.snapshot()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            serve(params, x)
        torch.cuda.current_stream(device).wait_stream(side)
        captured = counters.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.aux = serve(params, x)
        self.counts = tuple(counters.since(captured).items())
        counters.restore(before)

    def serves(self, params, scales) -> bool:
        """Whether a replay is the forward of ``params`` and ``scales``:
        the same dict holding the same tensor objects, the same device
        scales."""
        return (self.scales is scales and self.params is params
                and len(params) == len(self.tensors)
                and all(map(operator.is_, params.values(), self.tensors)))

    def replay(self):
        """(logits, aux) of the forward of what ``x`` holds, fresh tensors
        that a later replay does not overwrite."""
        self.graph.replay()
        for name, n in self.counts:
            counters.add(name, n)
        return self.logits.clone(), {k: v.clone() for k, v in self.aux.items()}

