"""The frozen serving forward replayed as a CUDA graph (``engine/engine.py``:
``_graph_forward``, ``_ServingGraph``).

On the CPU the serving forward never captures and answers as before; the
frozen scales go to the device once per set of values; and, with stand-ins
for ``torch.cuda``'s streams and graphs (on the CPU the "capture" runs the
forward, the "replay" runs nothing), a graph replays only for the params
dict, the tensors and the scales it was captured with at one input shape,
and a replay adds to the counters exactly what its capture counted.

The ``cuda`` tests hold the replayed forward to the one run module by module
on the card, bit for bit, for ResNet-50, MobileNet-v2, Inception-v3 and the
packed ResNet-50 trunk, with the counts of every call.  This file imports no
JAX, so the card runs it: ``python -m pytest --noconftest -m cuda
tests/test_torch_serving_graph.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy, engine as engine_mod
from cnn_quantization_tpu_torch.engine.context import ServingInt8Context
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.utils import counters, spans

SIZE = 64
GRAPH_KEYS = ('serving_graph.captures', 'serving_graph.replays')


def _images(n, size=SIZE, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _serving(arch, device, size=SIZE, grid='int8', packed=False, batch=2):
    """(engine, prepared params, frozen scales) of ``arch`` on ``device``."""
    model, meta = build_model(arch, device=device, seed=0, input_size=size)
    eng = QuantEngine(model, QuantPolicy(arch=arch, qtype=grid, qweight=grid), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    cal = [(_images(batch, size, seed=9), np.zeros(batch, np.int64))]
    return eng, sp, eng.freeze_serving_scales(sp, cal, packed=packed)


def _forward_counts(fwd, *args):
    """(answer, the counts of the ``engine.forward`` span of ``fwd(*args)``,
    what the counter store moved)."""
    before = counters.snapshot()
    held = spans.snapshot()['spans']
    mark = held[-1].seq if held else -1
    out = fwd(*args)
    (span,) = [s for s in spans.snapshot()['spans']
               if s.seq > mark and s.name == 'engine.forward']
    return out, span.counts, counters.since(before)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def resnet18_cpu():
    return _serving('resnet18', 'cpu')


def test_frozen_serving_on_the_cpu_never_captures(resnet18_cpu):
    """On the CPU the frozen serving forward runs module by module, counts no
    capture or replay, and answers as ``_run`` on a fresh context does."""
    eng, sp, scales = resnet18_cpu
    fwd = eng.make_forward('serving_int8', act_scales=scales)
    assert fwd.eager is fwd
    images = _images(2)
    for _ in range(2):
        (logits, aux), span_counts, moved = _forward_counts(fwd, sp, None, images)
        assert not set(GRAPH_KEYS) & (set(span_counts) | set(moved))
        assert span_counts == moved and span_counts   # the epilogues' counts, on either device
        assert aux == {}
    ctx = ServingInt8Context(act_scales=eng._scales_on_device(scales), act_bits=8,
                             weight_bits=8)
    want, _ = engine_mod._run(eng.model, sp, images, ctx, eng.device)
    assert torch.equal(logits, want)


def test_frozen_scales_go_to_the_device_once_per_set_of_values(resnet18_cpu):
    """Every ``make_forward`` of one set of frozen values gets the same
    device tensors, whatever dict holds them; other values, another vector
    or another site get their own; tensors given as scales go anew."""
    eng, _, scales = resnet18_cpu
    on_device = eng._scales_on_device(scales)
    assert eng._scales_on_device(scales) is on_device
    assert eng._scales_on_device(dict(scales)) is on_device
    site = next(iter(scales))
    assert on_device[site].dtype == torch.float32 and on_device[site].device == eng.device
    vec = {**scales, 'vec': np.array([0.5, 0.25], np.float32)}
    for other in ({**scales, site: scales[site] * 2}, vec,
                  {**vec, 'vec': np.array([0.5, 0.125], np.float32)},
                  {**scales, 'extra': 1.0}):
        assert eng._scales_on_device(other) is not on_device
    assert eng._scales_on_device(vec) is eng._scales_on_device(dict(vec))
    as_tensors = {k: torch.as_tensor(np.float32(v)) for k, v in scales.items()}
    assert eng._scales_on_device(as_tensors) is not eng._scales_on_device(as_tensors)
    assert eng._scales_on_device(None) == {} and eng._scales_on_device({}) == {}


class _StandInStream:
    def wait_stream(self, other):
        pass


class _StandInGraph:
    """A graph that replays nothing: on the CPU its "capture" ran the
    forward, so the captured outputs hold the captured images' answer."""

    def replay(self):
        pass


@pytest.fixture
def stand_in_graphs(monkeypatch):
    stream = _StandInStream()
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, 'stream', lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _StandInGraph)
    monkeypatch.setattr(torch.cuda, 'graph', lambda g: contextlib.nullcontext())


def test_stand_in_replay_adds_what_its_capture_counted(resnet18_cpu, stand_in_graphs):
    """The capturing call counts one forward, as an eager call does, and a
    capture; each replay adds exactly the captured counts and a replay;
    every call answers with a fresh tensor."""
    eng, sp, scales = resnet18_cpu
    eager = eng.make_forward('serving_int8', act_scales=scales)
    images = _images(2)
    (want, _), eager_counts, _ = _forward_counts(eager, sp, None, images)
    on_device = eng._scales_on_device(scales)
    graphs, cpu = {}, torch.device('cpu')

    def serve(params, x):
        return engine_mod._apply(eng.model, params, x, ServingInt8Context(
            act_scales=on_device, act_bits=8, weight_bits=8))

    answers = []
    for key in GRAPH_KEYS + GRAPH_KEYS[1:]:
        before = counters.snapshot()
        logits, aux = engine_mod._graph_forward(graphs, serve, sp, on_device, images, False, cpu)
        assert counters.since(before) == {**eager_counts, key: 1}
        assert torch.equal(logits, want) and aux == {}
        answers.append(logits)
    (graph,) = graphs.values()
    assert dict(graph.counts) == eager_counts
    ptrs = {a.data_ptr() for a in answers} | {graph.logits.data_ptr()}
    assert len(ptrs) == len(answers) + 1


def _weight_replaced(params, scales, images):
    params['w'] = params['w'].clone()   # the same dict, one tensor in it replaced
    return params, scales, images


# what the second call is given, after a first call on (params, scales, images)
KEY_CASES = {
    'same': lambda p, s, x: (p, s, x),
    'new_params_dict': lambda p, s, x: (dict(p), s, x),
    'replaced_tensor': _weight_replaced,
    'other_scales': lambda p, s, x: (p, dict(s), x),
    'new_batch_size': lambda p, s, x: (p, s, np.concatenate([x, x])),
}


@pytest.mark.parametrize('case', sorted(KEY_CASES))
def test_stand_in_graph_replays_only_what_it_captured(case, stand_in_graphs):
    """A second call replays only with the same params dict holding the same
    tensor objects, the same device scales and the same input shape; any
    other captures anew, in the first graph's place."""
    params, scales, images = {'w': torch.arange(4.0)}, {'s': torch.full((), 0.5)}, _images(2, 4)

    def serve(p, x):
        counters.add('concat.bytes', x.numel())
        return x.sum((1, 2, 3))[:, None] * p['w'], {}

    graphs, cpu = {}, torch.device('cpu')
    engine_mod._graph_forward(graphs, serve, params, scales, images, False, cpu)
    params2, scales2, images2 = KEY_CASES[case](params, scales, images)
    before = counters.snapshot()
    engine_mod._graph_forward(graphs, serve, params2, scales2, images2, False, cpu)
    moved = counters.since(before)
    captured = case != 'same'
    assert moved.get('serving_graph.captures', 0) == captured
    assert moved.get('serving_graph.replays', 0) == (not captured)
    assert moved['concat.bytes'] == images2.size
    assert len(graphs) == 1 + (case == 'new_batch_size')
    graph = next(g for key, g in graphs.items() if key[0] == images2.shape)
    assert graph.params is params2 and graph.scales is scales2


# ---- on the card


CARD_CASES = {
    'resnet50_b8': dict(arch='resnet50', size=224, batch=8),
    'mobilenet_v2': dict(arch='mobilenet_v2', size=224, batch=4),
    'inception_v3': dict(arch='inception_v3', size=299, batch=4),
    'resnet50_packed': dict(arch='resnet50', size=224, batch=4, grid='int4', packed=True),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_replay_equals_the_forward_run_module_by_module_on_card(case):
    """Each call's logits equal the forward run module by module on the same
    images bit for bit, two calls' answers never alias, the capturing call
    and each replay count what an eager forward counts key for key, plus one
    capture or one replay, and after the first call nothing captures."""
    _need_card()
    c = CARD_CASES[case]
    packed = c.get('packed', False)
    eng, sp, scales = _serving(c['arch'], 'cuda', size=c['size'], grid=c.get('grid', 'int8'),
                               packed=packed, batch=c['batch'])
    fwd = eng.make_forward('serving_int8', act_scales=scales, packed=packed)
    assert fwd.eager is not fwd
    answers = []
    for i in range(4):
        images = _images(c['batch'], c['size'], seed=i)
        (want, _), eager_counts, _ = _forward_counts(fwd.eager, sp, None, images)
        (got, aux), counts, moved = _forward_counts(fwd, sp, None, images)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (case, i, float((got - want).abs().max()))
        assert aux == {}
        key = 'serving_graph.captures' if i == 0 else 'serving_graph.replays'
        assert counts == moved == {**eager_counts, key: 1}, (case, i)
        if packed:
            assert eager_counts.get('int4_gemm.wgmma', 0) > 0
        answers.append(got)
    assert len({a.data_ptr() for a in answers}) == len(answers)
    # each kept answer is still its own images' (a later replay wrote none)
    for i, a in enumerate(answers):
        want, _ = fwd.eager(sp, None, _images(c['batch'], c['size'], seed=i))
        assert torch.equal(a, want)


@pytest.fixture(scope='module')
def resnet50_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return _serving('resnet50', 'cuda', size=SIZE)


CARD_KEY_CASES = ('new_params_dict', 'replaced_weight', 'other_scales', 'new_batch_size')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CARD_KEY_CASES))
def test_new_params_scales_or_shape_capture_anew_on_card(resnet50_card, case):
    """A new params dict, a replaced weight tensor in the dict replayed
    before, other frozen scales or another batch size capture anew, and the
    answer is that of the new inputs, never the stale graph's."""
    eng, sp, scales = resnet50_card
    params = dict(sp)
    fwd = eng.make_forward('serving_int8', act_scales=scales)
    fwd(params, None, _images(2))
    new_params, new_scales, batch = params, scales, 2
    if case == 'new_params_dict':
        new_params = dict(params)
    elif case == 'replaced_weight':
        # the same dict, one tensor in it replaced
        params['layer1.0.conv2.weight'] = -params['layer1.0.conv2.weight']
    elif case == 'other_scales':
        new_scales = {k: v * 1.5 for k, v in scales.items()}
    else:
        batch = 3
    images = _images(batch, seed=3)
    fwd2 = eng.make_forward('serving_int8', act_scales=new_scales)
    (got, _), counts, _ = _forward_counts(fwd2, new_params, None, images)
    want, _ = fwd2.eager(new_params, None, images)
    assert counts.get('serving_graph.captures') == 1 and 'serving_graph.replays' not in counts
    assert torch.equal(got, want)
    if case in ('replaced_weight', 'other_scales'):
        stale, _ = fwd.eager(sp, None, images)
        assert not torch.equal(got, stale)
