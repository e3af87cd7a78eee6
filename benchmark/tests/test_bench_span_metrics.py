"""Each span reader on a recorded span list, in the form the program's
``utils/spans.snapshot()`` gives it: a set-up (weight pass, calibration of
three batches), then a window of two requests or batches, then spans after
the window (the traced stretch), which no reader may count."""

import pytest

from benchmark import harness, span_reads
from cnn_quantization_tpu_torch.utils.spans import SpanRecord

MS = 1_000_000
T0 = 1_000 * MS           # the window's first stamp, in ns


def _spans(path='serving'):
    out, seq = [], iter(range(1000))

    def add(name, start, end, parent=None, counts=None):
        s = SpanRecord(next(seq), name, start, end, parent, 0, counts)
        out.append(s)
        return s.seq

    # set-up: the weight pass, then the calibration's three batches
    add('engine.quantize_params', 10 * MS, 610 * MS, counts={'weights': 54})
    if path == 'sim':
        top = add('calib.collect', 620 * MS, 900 * MS)
        add('engine.freeze_qparams', 900 * MS, 950 * MS)
    else:
        add('engine.prepare_serving_params', 610 * MS, 650 * MS)
        top = add('engine.freeze_serving_scales', 650 * MS, 950 * MS)
    for a, b in ((660, 860), (860, 880), (880, 904)):   # 200, 20 and 24 ms
        add('calib.batch', a * MS, b * MS, parent=top)
    # the window: two forwards of 10 and 14 ms, their copies 2 and 4 ms
    for start, length, copy in ((T0 + MS, 10, 2), (T0 + 20 * MS, 14, 4)):
        b = add('evaluate.batch', start, start + (length + 1) * MS)
        f = add('engine.forward', start, start + length * MS, parent=b)
        add('device.h2d', start, start + copy * MS, parent=f)
    # after the window: a traced forward of 100 ms
    f = add('engine.forward', T0 + 60_000 * MS, T0 + 60_100 * MS)
    add('device.h2d', T0 + 60_000 * MS, T0 + 60_050 * MS, parent=f)
    return out


def record(path='serving', loop='sweep'):
    return {'cell': 'x', 'traffic': {'path': path, 'loop': loop, 'batch': 128},
            'window': {'stamps': [T0 / 1e9, (T0 + 20 * MS) / 1e9], 'seconds': 51.0}}


@pytest.fixture
def held(monkeypatch):
    """Feed the readers a snapshot; returns a setter for its spans and the
    stamp from which it holds them whole."""
    snap = {'spans': _spans(), 'held_from_ns': 0}
    monkeypatch.setattr(span_reads, 'snapshot', lambda: snap)

    def put(spans=None, held_from_ns=0):
        snap['spans'] = _spans() if spans is None else spans
        snap['held_from_ns'] = held_from_ns
    return put


def read(name, rec):
    return harness.reader(name).read(rec)


def test_window_readers(held):
    sweep, online = record(), record(loop='closed')
    assert read('forward_host_ms.sweep', sweep) == pytest.approx(9.0)     # 8 and 10
    assert read('forward_host_ms.online', online) == pytest.approx(9.0)
    assert read('h2d_wait_ms.sweep', sweep) == pytest.approx(3.0)         # 2 and 4
    assert read('forward_host_ms.online', sweep) is None
    assert read('forward_host_ms.sweep', online) is None
    assert read('h2d_wait_ms.sweep', online) is None


@pytest.mark.parametrize('path', ['sim', 'serving'])
def test_setup_readers(held, path):
    held(_spans(path))
    rec = record(path=path)
    weights = 0.600 if path == 'sim' else 0.640
    calibration = 0.330 if path == 'sim' else 0.300
    assert read('prep_weights_s', rec) == pytest.approx(weights)
    assert read('prep_calibration_s', rec) == pytest.approx(calibration)
    # 200 ms less the median of 20 and 24 ms
    assert read('calibration_first_batch_s', rec) == pytest.approx(0.178)


def test_missing_spans_read_none(held):
    held([s for s in _spans() if s.name not in ('calib.batch', 'engine.forward')])
    for name in ('calibration_first_batch_s', 'forward_host_ms.sweep'):
        assert read(name, record()) is None
    held([])
    for name in ('prep_weights_s', 'prep_calibration_s', 'h2d_wait_ms.sweep'):
        assert read(name, record()) is None


def test_overwritten_spans_read_none(held):
    # the ring lost spans that began inside the window: no window reader reads
    held(held_from_ns=T0 + 5 * MS)
    for name in ('forward_host_ms.sweep', 'h2d_wait_ms.sweep', 'prep_weights_s'):
        assert read(name, record()) is None
    assert read('forward_host_ms.online', record(loop='closed')) is None
    # it lost only set-up spans: the window reads, the set-up does not
    held(held_from_ns=700 * MS)
    assert read('forward_host_ms.sweep', record()) == pytest.approx(9.0)
    for name in ('prep_weights_s', 'prep_calibration_s', 'calibration_first_batch_s'):
        assert read(name, record()) is None


def test_program_without_spans_reads_none(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_spans(name, *args, **kwargs):
        if name.startswith('cnn_quantization_tpu_torch'):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_spans)
    assert span_reads.snapshot() is None
    for name in ('forward_host_ms.sweep', 'h2d_wait_ms.sweep', 'prep_weights_s',
                 'prep_calibration_s', 'calibration_first_batch_s'):
        assert read(name, record()) is None
