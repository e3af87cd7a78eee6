"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the plain reference, and the result line.

Driven by data: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``; each
metric is read by ``metrics/<metric>.py``.  A new cell or metric is new files.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import inputs, judge, program, trace, yardstick
from .reference import recipes

HERE = Path(__file__).resolve().parent
SPEC = HERE.parent / 'BENCHMARK.json'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cnn_quantization_tpu')


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec: dict | None = None) -> dict:
    """The workload ``name`` with its configuration, traffic and limits."""
    spec = spec or load_json(SPEC)
    work = next((w for w in spec['workloads'] if w['name'] == name), None)
    if work is None:
        raise SystemExit(f'no workload {name!r} in {SPEC.name}')
    config = next(c for c in spec['configs'] if c['name'] == work['config'])
    return {'spec': spec, 'workload': work,
            'config': load_json(HERE.parent / config['file']),
            'traffic': load_json(HERE / 'traffic' / f"{work['traffic']}.json"),
            'limits': load_json(HERE / 'limits' / f'{name}.json')}


def reader(metric: str):
    """The module ``metrics/<metric>.py``; its ``read(record)`` returns the
    metric's value, or None where the record holds nothing to read."""
    path = HERE / 'metrics' / f'{metric}.py'
    mod_spec = importlib.util.spec_from_file_location(f'benchmark_metric_{metric}', path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    a trace its per-layer metrics."""
    e2e = [m for m in spec['end_to_end'] if cell in m.get('workloads', [cell])]
    if not traced:
        return e2e
    names = {m['name'] for m in e2e}

    def applies(m):
        return cell in m['workloads'] if 'workloads' in m else m['moves'] in names

    return [m for m in spec['per_layer'] if applies(m)]


def forbidden_modules() -> list:
    import sys
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, traced: bool, *, device='cuda',
             overrides: dict | None = None, fault=None, t_start: float | None = None,
             spec: dict | None = None) -> dict:
    """The result line of one run.  ``overrides`` (tests) resize the cell;
    ``fault`` (tests) breaks every forward's answer; ``spec`` (tests) stands in
    for ``BENCHMARK.json``."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = load_cell(name, spec)
    config, traffic = dict(cell['config']), dict(cell['traffic'])
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    arch, size, batch = config['arch'], config['input_size'], traffic['batch']
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = config['tf32']

    # ---- set-up
    recipes.require(traffic)
    program.build_kernels(device)
    engine, shapes = program.build(config, traffic['recipe'], device)
    params, pool, calibration = make_inputs(shapes, config, traffic, seed, device)
    state, prep = program.prepare(engine, params, traffic, calibration, size)
    loop = traffic['loop']
    if loop == 'sweep':
        program.sweep(engine, state, traffic, pool, batches=traffic['warmup'])
    else:
        program.closed_loop(engine, state, pool, requests=traffic['warmup'])
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the measured window
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    if loop == 'sweep':
        window = program.sweep(engine, state, traffic, pool, seconds=seconds, fault=fault)
    else:
        window = program.closed_loop(engine, state, pool, seconds=seconds, fault=fault)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    window['images_per_s'] = window['images'] / window['seconds']

    traced_summary = None
    if traced and device.type == 'cuda':
        units = traffic['trace_units']
        if loop == 'sweep':
            traced_summary = trace.profile(
                lambda: program.sweep(engine, state, traffic, pool, batches=units))
        else:
            traced_summary = trace.profile(
                lambda: program.closed_loop(engine, state, pool, requests=units))
        traced_summary['units'] = units
        # the same work's host time without the profiler, at the window's pace
        traced_summary['untraced_s'] = units * window['seconds'] / max(len(window['order']), 1)

    # ---- the check, with the program's state freed
    del engine
    gc.collect()
    t_check = time.perf_counter()
    numbers = check(arch, size, traffic, state, window, params, calibration, pool, device)
    check_s = time.perf_counter() - t_check
    correct, checks = judge.verdict(numbers, cell['limits'])

    record = {'cell': name, 'config': config, 'traffic': traffic, 'setup_s': setup_s,
              'prep': prep, 'window': window, 'trace': traced_summary,
              'work': yardstick.work(arch, size, batch), 'peaks': yardstick.PEAKS}
    metrics = {}
    for m in cell_metrics(cell['spec'], name, traced):
        value = reader(m['name']).read(record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device) if device.type == 'cuda' else device.type,
           'count': 1, 'memory_peak_bytes': memory_peak}
    # a batch or request either completes or ends the run with an error
    out = {'correct': correct, 'attempted': len(window['order']), 'failed': 0,
           'metrics': metrics, 'device': dev}
    if traced_summary is not None:
        dev['busy_s'], dev['window_s'] = traced_summary['busy_s'], traced_summary['window_s']
        out['breakdown'] = {k: [[n, s] for n, s in traced_summary[k]]
                            for k in ('device_ops', 'idle_gaps')}
    # beside the result: the card's power limit and where the run's time went
    out['card'] = card(device)
    out['seconds'] = {'window': window['seconds'], 'check': check_s,
                      'window_by_second': by_second(window)}
    out['checks'] = checks
    return out


def by_second(window) -> list:
    """Images/s of the window's successive stretches of a second or more."""
    st = window['stamps']
    per = window['images'] / max(len(st), 1)
    out, j = [], 0
    for i in range(1, len(st)):
        if st[i] - st[j] >= 1.0:
            out.append(per * (i - j) / (st[i] - st[j]))
            j = i
    return out


def card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    if device.type != 'cuda':
        return device.type
    import subprocess
    try:
        proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=60)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def make_inputs(shapes, config, traffic, seed, device):
    """(float weights on the card, the window's pinned host batches, the
    calibration's), all from ``seed``."""
    size, batch = config['input_size'], traffic['batch']
    params = inputs.make_weights(shapes, seed, device)
    images, labels = inputs.make_images(traffic['pool'] * batch, size, seed, inputs.IMAGES,
                                        device)
    pool = inputs.host_batches(images, labels, batch)
    images, labels = inputs.make_images(traffic['calibration_images'], size, seed,
                                        inputs.CALIBRATION, device)
    return params, pool, inputs.host_batches(images, labels, traffic['calibration_batch'])


def check(arch, size, traffic, state, window, params, calibration, pool, device):
    """The numbers ``judge`` compares: the reference works the recipe out
    again from the float weights and calibration images, and computes the
    logits of every pool entry the window sent."""
    cal = [x for x, _ in calibration]
    needed = sorted(set(window['order']))
    with torch.no_grad():
        if traffic['path'] == 'sim':
            ref_pq = recipes.sim_weights(arch, params)
            ref_qp = recipes.freeze(arch, recipes.collect(arch, params, cal, device), size,
                                    device)
            numbers = {'weights': judge.tree_gap(state['params'], ref_pq),
                       'qparams': judge.qparams_gap(state['qparams'], ref_qp)}
            ref_logits = {k: recipes.sim_logits(arch, ref_pq, ref_qp, pool[k][0], device)
                          for k in needed}
        else:
            ref_ps = recipes.serving_weights(params)
            ref_scales = recipes.serving_scales(arch, ref_ps, cal, device)
            numbers = {'weights': judge.tree_gap(state['params'], ref_ps),
                       'scales': judge.scales_gap(state['scales'], ref_scales)}
            ref_logits = {k: recipes.serving_logits(arch, ref_ps, ref_scales, pool[k][0], device)
                          for k in needed}
    ref_logits = {k: v.to(device) for k, v in ref_logits.items()}
    numbers['logits'] = judge.logits_gap(window['logits'], window['order'], ref_logits)
    if traffic['loop'] == 'sweep':
        labels = [y.to(device) for _, y in pool]
        numbers.update(judge.sweep_numbers(window, labels, ref_logits))
    return {k: (v if isinstance(v, int) or math.isfinite(v) else judge.INF)
            for k, v in numbers.items()}


def control_numbers(name: str, seed: int, *, device='cuda', overrides=None, spec=None) -> dict:
    """The numbers of the control: the reference computed in the precision
    below the configuration's (``recipes.precision``, ``recipes.weights_read``)
    put in the program's place, judged against the reference, each pool entry
    sent once."""
    device = torch.device(device)
    cell = load_cell(name, spec)
    config, traffic = dict(cell['config']), dict(cell['traffic'])
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    arch, size = config['arch'], config['input_size']
    recipes.require(traffic)
    params, pool, calibration = make_inputs(recipes.model(arch).param_shapes(), config,
                                            traffic, seed, device)
    cal = [x for x, _ in calibration]
    low = recipes.weights_read(params, True)
    order = list(range(len(pool)))
    with torch.no_grad():
        if traffic['path'] == 'sim':
            pq = recipes.sim_weights(arch, low)
            qp = recipes.freeze(arch, recipes.collect(arch, low, cal, device, control=True),
                                size, device)
            state = {'params': pq, 'qparams': {
                k: SimpleNamespace(delta=d, offset=o, qmax=q, per_channel=pc)
                for k, (d, o, q, pc) in qp.items()}}
            logits = [recipes.sim_logits(arch, pq, qp, x, device, control=True) for x, _ in pool]
        else:
            ps = recipes.serving_weights(low)
            scales = recipes.serving_scales(arch, ps, cal, device, control=True)
            state = {'params': ps, 'scales': scales}
            logits = [recipes.serving_logits(arch, ps, scales, x, device, control=True)
                      for x, _ in pool]
    window = {'order': order, 'logits': logits, 'images': sum(x.shape[0] for x, _ in pool)}
    if traffic['loop'] == 'sweep':
        window['result'] = _eval_result(logits, [y.to(device) for _, y in pool])
    return check(arch, size, traffic, state, window, params, calibration, pool, device)


def _eval_result(logits, labels) -> dict:
    """What ``evaluate`` returns for these logits: percent top-1/top-5 and the
    mean cross entropy."""
    n = sum(l.shape[0] for l in logits)
    out = {'loss': 0.0, 'top1': 0.0, 'top5': 0.0}
    for l, y in zip(logits, labels):
        top = torch.argsort(-l, dim=-1, stable=True)[:, :5] == y.long()[:, None]
        out['top1'] += 100.0 * top[:, :1].sum().item() / n
        out['top5'] += 100.0 * top.sum().item() / n
        out['loss'] += -torch.log_softmax(l.double(), -1).gather(
            1, y.long().view(-1, 1)).sum().item() / n
    return out
