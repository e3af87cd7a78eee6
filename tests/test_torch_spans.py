"""The port's spans (``utils/spans.py``): their nesting and ids through the
eval loop, the preparation's phases, their entries in the profiler's host
timeline, the anchor to the profiler's clock, the fine spans' level and the
ring's bound.  On the CPU at 64x64; the one ``cuda`` test reads a serving
forward's launch counts on the card."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cnn_quantization_tpu_torch.calib.calibrator import collect_statistics
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.ops.kernels import build
from cnn_quantization_tpu_torch.utils import counters, spans

SIZE = 64
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)
COARSE = {'evaluate.stats', 'evaluate.fetch', 'evaluate.batch', 'evaluate.meters',
          'engine.forward', 'device.h2d'}


def _batches(n, batch=2, seed=0, size=SIZE):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, size, size, 3).astype(np.float32),
             rng.randint(0, 1000, batch).astype(np.int64)) for _ in range(n)]


def _engine(arch, device='cpu', size=SIZE, **policy):
    model, meta = build_model(arch, device=device, input_size=size)
    return QuantEngine(model, QuantPolicy(arch=arch, **policy), meta), model.state_dict()


def _since(mark):
    """The process's spans opened after the sequence number ``mark``."""
    return [s for s in spans.snapshot()['spans'] if s.seq > mark]


def _mark():
    held = spans.snapshot()['spans']
    return held[-1].seq if held else -1


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def resnet18():
    return _engine('resnet18')


def test_eval_loop_nesting_and_ids(resnet18):
    eng, params = resnet18
    mark = _mark()
    evaluate(eng, params, _batches(2), quantized=False)
    got = _since(mark)
    by_seq = {s.seq: s for s in got}
    batches = [s for s in got if s.name == 'evaluate.batch']
    assert [s.batch for s in batches] == [0, 1]
    assert [s.counts for s in batches] == [{'images': 2}] * 2
    # one wait on the iterator a batch, and the one that finds it empty
    assert sum(s.name == 'evaluate.fetch' for s in got) == 3
    for b in batches:
        kids = [s for s in got if s.parent == b.seq]
        assert [k.name for k in kids] == ['engine.forward', 'evaluate.meters']
        fwd = kids[0]
        copies = [s for s in got if s.parent == fwd.seq]
        assert [c.name for c in copies] == ['device.h2d']
        assert copies[0].counts == {'bytes': 2 * SIZE * SIZE * 3 * 4}
        # a batch's spans share its id and lie inside their parents
        for s in (fwd, copies[0], kids[1]):
            assert s.batch == b.batch
            p = by_seq[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert fwd.counts == {}    # the CPU runs the kernels' plain versions
    # with the profiler off, no fine span
    assert not any(s.name.startswith('layer.') for s in got)


def _setup_spans(mark):
    got = _since(mark)
    return collections.Counter(s.name for s in got if s.parent is None), got


def test_simulation_preparation_spans():
    eng, params = _engine('resnet18', **HEADLINE)
    mark = _mark()
    pq = eng.quantize_params(params)
    stats = collect_statistics(eng.make_collect(err_bits=4), params, _batches(3),
                               cal_set_size=4)
    qparams = eng.freeze_qparams(stats, input_shape=(1, SIZE, SIZE, 3))
    top, got = _setup_spans(mark)
    assert top == {'engine.quantize_params': 1, 'calib.collect': 1, 'engine.freeze_qparams': 1}
    (wp,) = [s for s in got if s.name == 'engine.quantize_params']
    n_weights = sum(1 for k, v in params.items() if k.endswith('.weight') and v.ndim in (2, 4))
    assert wp.counts == {'weights': n_weights}
    assert sum(torch.equal(pq[k], params[k]) for k in params) < len(params)
    for name in ('weight.grid', 'weight.bias_corr'):
        kids = [s for s in got if s.name == name]
        assert len(kids) == n_weights and all(s.parent == wp.seq for s in kids)
    (col,) = [s for s in got if s.name == 'calib.collect']
    assert col.counts == {'images': 4}
    cal = [s for s in got if s.name == 'calib.batch']
    assert len(cal) == 2 and all(s.parent == col.seq for s in cal)
    # each calibration batch holds its forward and that forward's copy
    for c in cal:
        (fwd,) = [s for s in got if s.parent == c.seq]
        assert fwd.name == 'engine.forward'
        assert [s.name for s in got if s.parent == fwd.seq] == ['device.h2d']
    (fq,) = [s for s in got if s.name == 'engine.freeze_qparams']
    assert fq.counts == {'sites': len(qparams)}


def test_serving_preparation_spans():
    eng, params = _engine('resnet18', qtype='int8', qweight='int8')
    mark = _mark()
    ps = eng.prepare_serving_params(eng.quantize_params(params))
    scales = eng.freeze_serving_scales(ps, _batches(3), max_batches=2)
    top, got = _setup_spans(mark)
    assert top == {'engine.quantize_params': 1, 'engine.prepare_serving_params': 1,
                   'engine.freeze_serving_scales': 1}
    (prep,) = [s for s in got if s.name == 'engine.prepare_serving_params']
    assert prep.counts == {'weights': sum(k.endswith('.w_scale') for k in ps)}
    (fz,) = [s for s in got if s.name == 'engine.freeze_serving_scales']
    assert fz.counts == {'sites': len(scales), 'images': 4}
    cal = [s for s in got if s.name == 'calib.batch']
    assert len(cal) == 2 and all(s.parent == fz.seq for s in cal)
    for c in cal:
        assert [s.name for s in got if s.parent == c.seq] == ['device.h2d']


def test_kernel_load_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'library_path', lambda name: tmp_path / f'lib{name}.so')
    (tmp_path / 'libfound.so').touch()
    monkeypatch.setattr(build, 'build_library', lambda name: (build.library_path(name), ''))
    mark = _mark()
    out = build.build_libraries(['found', 'fresh'])
    assert set(out) == {'found', 'fresh'} and all(s >= 0 for _, _, s in out.values())
    got = _since(mark)
    (top,) = [s for s in got if s.name == 'kernels.load']
    kids = {s.name: s for s in got if s.parent == top.seq}
    assert kids['kernels.load.found'].counts == {'built': 0}
    assert kids['kernels.load.fresh'].counts == {'built': 1}


@pytest.mark.parametrize('arch, fine', [
    ('resnet18', {'layer.QConv', 'layer.BasicBlock', 'layer.QMaxPool', 'layer.QLinear'}),
    ('resnet50', {'layer.Bottleneck'}),
    ('mobilenet_v2', {'layer.InvertedResidual', 'layer.QBatchNorm'}),
    ('alexnet', {'layer.ReLU'}),
    ('inception_v3', {f'layer.Inception{k}' for k in 'ABCDE'}),
])
def test_every_span_in_the_profiler_host_timeline(arch, fine):
    size = 75 if arch == 'inception_v3' else SIZE   # its smallest input
    eng, params = _engine(arch, size=size)
    batches = _batches(2, batch=1, size=size)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mark = _mark()
        evaluate(eng, params, batches, quantized=False)
        got = _since(mark)
    names = collections.Counter(s.name for s in got)
    assert COARSE <= set(names) and fine <= set(names)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in names]
    # one host event a span, a cpu_op: not a user annotation, nothing on a device
    assert collections.Counter(e.name() for e in events) == names
    assert not any(e.is_user_annotation() for e in events)
    assert all(str(e.device_type()).endswith('CPU') for e in events)
    # the anchor puts a span on the profiler's clock within a millisecond
    fwd_ev = min((e for e in events if e.name() == 'engine.forward'),
                 key=lambda e: e.start_ns())
    fwd = next(s for s in got if s.name == 'engine.forward')
    assert abs(spans.to_unix_ns(fwd.start_ns) - fwd_ev.start_ns()) < 1_000_000


def test_chrome_trace_holds_the_spans(resnet18, tmp_path):
    import json
    from cnn_quantization_tpu_torch.utils import profiling
    eng, params = resnet18
    fwd = eng.make_forward(quantized=False)
    with profiling.trace(str(tmp_path / 'trace.json')) as path:
        fwd(params, None, _batches(1, batch=1)[0][0])
    events = json.loads(open(path).read())['traceEvents']
    cats = {e['name']: e.get('cat') for e in events
            if e.get('name') in ('engine.forward', 'device.h2d', 'layer.BasicBlock')}
    assert cats == dict.fromkeys(('engine.forward', 'device.h2d', 'layer.BasicBlock'), 'cpu_op')


def test_no_fine_span_without_a_profiler(resnet18):
    eng, params = resnet18
    fwd = eng.make_forward(quantized=False)
    mark = _mark()
    fwd(params, None, _batches(1)[0][0])
    got = _since(mark)
    assert [s.name for s in got] == ['engine.forward', 'device.h2d']
    assert got[0].batch == got[0].seq and got[1].batch == got[0].seq


def test_ring_bound():
    rec = spans.Recorder(capacity=8)
    assert rec.snapshot()['held_from_ns'] == 0
    for _ in range(5):
        with rec.span('a'):
            with rec.span('b'):
                pass
    snap = rec.snapshot()
    held = snap['spans']
    assert len(held) == 8 and [s.seq for s in held] == list(range(2, 10))
    # the two overwritten spans began before every span the ring still holds
    assert 0 < snap['held_from_ns'] <= held[0].start_ns
    with pytest.raises(ValueError):
        spans.Recorder(capacity=12)
    assert spans.CAPACITY == spans.RECORDER.capacity >= 1 << 17


@pytest.mark.cuda
def test_serving_forward_counts_launches_by_route():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    eng, params = _engine('resnet18', device='cuda', qtype='int8', qweight='int8')
    ps = eng.prepare_serving_params(eng.quantize_params(params))
    scales = eng.freeze_serving_scales(ps, _batches(1))
    fwd = eng.make_forward('serving_int8', act_scales=scales)
    before = counters.snapshot()
    mark = _mark()
    fwd(ps, None, _batches(1)[0][0])
    torch.cuda.synchronize()
    (f,) = [s for s in _since(mark) if s.name == 'engine.forward']
    # ResNet-18: 16 3x3 convs past the float stem and 3 strided 1x1
    # downsamples on the conv kernel, the classifier on the GEMM
    by_kernel = collections.Counter()
    for key, n in f.counts.items():
        if key.split('.')[1] not in ('codes_out', 'residual_in', 'float_in_bytes') \
                and not key.startswith(('quantize_codes.', 'serving_graph.')):
            by_kernel[key.split('.')[0]] += n
    assert by_kernel == {'int8_conv': 19, 'int8_gemm': 1}
    # the float hand-off's codes kernel: the stem output and the classifier's input
    assert f.counts['quantize_codes.launches'] == 2
    # nothing launched outside the span
    moved = counters.by_kernel(counters.since(before))
    assert by_kernel['int8_conv'] == moved['int8_conv']
    assert by_kernel['int8_gemm'] == moved['int8_gemm']
    assert f.counts['int8_gemm.wgmma'] == 1    # K = 512
    # codes out of every conv but the last block's conv2 (8 conv1, 3
    # downsamples, 7 conv2), the identity into each block's conv2
    assert (f.counts['int8_conv.codes_out'], f.counts['int8_conv.residual_in']) == (18, 8)
