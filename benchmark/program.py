"""The system under test: the PyTorch and CUDA package, driven through its own
entry points.  The only module of the benchmark that imports it.

* set-up: the model built without weights and given the benchmark's; the
  recipe prepared from the float weights and the calibration images
  (``QuantEngine.quantize_params`` and ``calib.calibrator.collect_statistics``
  + ``freeze_qparams`` for the simulation; ``quantize_params``,
  ``prepare_serving_params`` and ``freeze_serving_scales`` for serving);
* the sweep: ``engine.evaluate.evaluate`` over host batches until a deadline;
* the closed loop: ``QuantEngine.make_forward(quantized='serving_int8')``, one
  request of host images at a time, its top-5 indices read back to the host
  before the next is sent.

Each forward's logits are kept (device references, no copy) for the check
after the window.  ``fault`` (tests only) breaks each forward's answer.
"""

from __future__ import annotations

import time

import torch

KERNELS = ('fake_quant', 'int8_gemm', 'int8_conv')


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def build_kernels(device):
    """Build the kernels the cells launch, all at once (a checkout's first
    run; later runs find them built)."""
    if device.type == 'cuda':
        from cnn_quantization_tpu_torch.ops.kernels import build
        build.build_libraries(KERNELS)


def build(config: dict, recipe: dict, device):
    """(engine, float parameter shapes): the model on ``device`` without
    weights of its own; every forward takes its parameters by name."""
    from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
    from cnn_quantization_tpu_torch.models import build_model
    model, meta = build_model(config['arch'], device='meta', input_size=config['input_size'])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model = model.to_empty(device=device).eval()
    policy = QuantPolicy(arch=config['arch'], **recipe)
    return QuantEngine(model, policy, meta), shapes


def prepare(engine, params, traffic: dict, calibration: list, input_size: int):
    """(prepared state, seconds of its parts)."""
    from cnn_quantization_tpu_torch.engine.policy import parse_qtype_bits
    device = engine.device
    t0 = time.perf_counter()
    pq = engine.quantize_params(params)
    if traffic['path'] == 'sim':
        _sync(device)
        t1 = time.perf_counter()
        from cnn_quantization_tpu_torch.calib.calibrator import collect_statistics
        # the CLI's ``-sm use`` collects the error columns at the recipe's bits
        err_bits = parse_qtype_bits(engine.policy.qtype)
        stats = collect_statistics(engine.make_collect(err_bits=err_bits), params, calibration,
                                   cal_set_size=traffic['calibration_images'])
        qparams = engine.freeze_qparams(stats, input_shape=(1, input_size, input_size, 3))
        state = {'params': pq, 'stats': stats, 'qparams': qparams}
    else:
        ps = engine.prepare_serving_params(pq)
        _sync(device)
        t1 = time.perf_counter()
        scales = engine.freeze_serving_scales(ps, calibration, max_batches=len(calibration))
        state = {'params': ps, 'scales': scales}
    _sync(device)
    t2 = time.perf_counter()
    return state, {'weight_pass_s': t1 - t0, 'calibration_s': t2 - t1}


class _Capture:
    """The engine as ``evaluate`` sees it, with each forward's logits kept."""

    def __init__(self, engine, sink: list, fault=None):
        self._engine, self._sink, self._fault = engine, sink, fault

    @property
    def device(self):
        return self._engine.device

    def make_forward(self, *args, **kwargs):
        fwd = self._engine.make_forward(*args, **kwargs)

        def forward(params, stats, images):
            logits, aux = fwd(params, stats, images)
            if self._fault is not None:
                logits = self._fault(logits)
            self._sink.append(logits)
            return logits, aux

        return forward


def sweep(engine, state, traffic, pool, *, seconds=None, batches=None, fault=None):
    """``evaluate`` over ``pool``'s batches in turn, until ``seconds`` have
    passed (checked before each batch) or ``batches`` were sent.  Returns
    {'result', 'order', 'logits', 'seconds', 'images'}."""
    from cnn_quantization_tpu_torch.engine.evaluate import evaluate
    if traffic['path'] == 'sim':
        kwargs = {'stats': state['stats'], 'qparams': state['qparams']}
    else:
        kwargs = {'quantized': 'serving_int8', 'act_scales': state['scales']}
    order, logits = [], []
    clock = {}

    stamps = []

    def feed():
        i = 0
        while (batches is None or i < batches) and \
                (seconds is None or time.perf_counter() < clock['deadline']):
            stamps.append(time.perf_counter())
            order.append(i % len(pool))
            yield pool[order[-1]]
            i += 1

    t0 = time.perf_counter()
    clock['deadline'] = t0 + (seconds or 0.0)
    result = evaluate(_Capture(engine, logits, fault), state['params'], feed(), **kwargs)
    elapsed = time.perf_counter() - t0
    return {'result': result, 'order': order, 'logits': logits, 'seconds': elapsed,
            'images': sum(pool[k][0].shape[0] for k in order), 'stamps': stamps}


def closed_loop(engine, state, pool, *, seconds=None, requests=None, fault=None):
    """One client: send ``pool``'s requests in turn, each after the last one's
    top-5 indices are on the host.  Returns {'order', 'logits', 'latency_s',
    'dispatch_s', 'stamps', 'seconds', 'images'}; ``dispatch_s`` is the host
    time of the forward call alone (its launches, no synchronise)."""
    fwd = engine.make_forward('serving_int8', act_scales=state['scales'])
    params = state['params']
    out = {'order': [], 'logits': [], 'latency_s': [], 'dispatch_s': [], 'stamps': []}
    t0 = time.perf_counter()
    deadline = t0 + (seconds or 0.0)
    i = 0
    while (requests is None or i < requests) and \
            (seconds is None or time.perf_counter() < deadline):
        k = i % len(pool)
        ts = time.perf_counter()
        logits, _ = fwd(params, None, pool[k][0])
        if fault is not None:
            logits = fault(logits)
        td = time.perf_counter()
        torch.topk(logits, 5, dim=-1).indices.cpu()
        te = time.perf_counter()
        for key, v in (('order', k), ('logits', logits), ('latency_s', te - ts),
                       ('dispatch_s', td - ts), ('stamps', ts)):
            out[key].append(v)
        i += 1
    out['seconds'] = time.perf_counter() - t0
    out['images'] = sum(pool[k][0].shape[0] for k in out['order'])
    return out
