"""Each metric reader on a recorded profiler table: the device and host
records of two batches of a serving sweep in the form
``trace.summarize`` reads (name, start ns, duration ns), cut to a few rows."""

import pytest

from benchmark import harness, trace, yardstick

DEVICE = [  # two batches: copy, integer kernels, elementwise passes
    ('Memcpy HtoD (Pinned -> Device)', 0, 1_500_000),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::Tile<128>, cnnq::wg::DenseA, x>', 2_000_000,
     3_000_000),
    ('void at::native::vectorized_elementwise_kernel<4, round>', 5_000_000, 9_000_000),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::ConvRing<128, 128>, cnnq::wg::Im2colA, x>',
     14_500_000, 2_000_000),
    ('Memcpy HtoD (Pinned -> Device)', 20_000_000, 1_500_000),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::Tile<128>, cnnq::wg::DenseA, x>', 22_000_000,
     3_000_000),
    ('void at::native::vectorized_elementwise_kernel<4, round>', 25_000_000, 9_000_000),
    ('void at::native::vectorized_elementwise_kernel<4, add>', 30_000_000, 2_000_000),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::ConvRing<128, 128>, cnnq::wg::Im2colA, x>',
     34_000_000, 2_000_000),
]
HOST = [('aten::copy_', 0, 2_000_000), ('cudaStreamSynchronize', 16_000_000, 4_000_000),
        ('aten::conv', 21_000_000, 500_000)]


def record(path='serving', loop='sweep', traced=True, batch=128):
    t = trace.summarize(DEVICE, HOST, window_s=0.040) if traced else None
    if t is not None:
        t['units'], t['untraced_s'] = 2, 0.036
    return {'cell': 'x', 'traffic': {'path': path, 'loop': loop, 'batch': batch},
            'setup_s': 12.5,
            'prep': {'weight_pass_s': 0.9, 'calibration_s': 0.5},
            'window': {'images_per_s': 3200.0, 'result': {'images_per_sec': 3400.0},
                       'latency_s': [0.010] * 19 + [0.020], 'dispatch_s': [0.006, 0.008, 0.007]},
            'trace': t, 'work': yardstick.work('resnet50', 224, batch), 'peaks': yardstick.PEAKS}


def test_summary_of_the_table():
    t = trace.summarize(DEVICE, HOST, window_s=0.040)
    # the union of the intervals: the overlap of the add and the round counts once
    assert t['busy_s'] == pytest.approx(0.031)
    assert t['class_s']['int8_gemm'] == pytest.approx(0.006)
    assert t['class_s']['int8_conv'] == pytest.approx(0.004)
    assert t['class_s']['elementwise'] == pytest.approx(0.020)
    assert t['kernels'] == 7
    assert t['idle_gaps'][0][0] == 'cudaStreamSynchronize'


def read(name, rec):
    return harness.reader(name).read(rec)


def test_sweep_readers():
    rec = record()
    # against the untraced pace (0.036 s for two batches), not the traced 0.040 s
    assert read('idle_share.sweep', rec) == pytest.approx(100 * (1 - 0.031 / 0.036))
    assert read('idle_share.online', rec) is None
    assert read('elementwise_ms.serving', rec) == pytest.approx(10.0)
    bound = yardstick.work('resnet50', 224, 128)['int8_bound_s']
    assert read('int8_roofline.serving', rec) == pytest.approx(100 * bound / 0.005)
    ops = yardstick.work('resnet50', 224, 128)['ops'] / 128
    assert read('mfu.serving', rec) == pytest.approx(100 * ops * 3200 / 1979e12)
    assert read('mfu.sim', rec) is None
    assert read('loop_device_ms.sweep', rec) == pytest.approx(1e3 * 128 / 3400)
    assert read('images_per_s', rec) == 3200.0 and read('setup_s', rec) == 12.5
    assert read('fake_quant_roofline.sim', rec) is None   # no fake-quant in this table


def test_sim_readers():
    rec = record(path='sim')
    assert read('weight_pass_s.sim', rec) == 0.9 and read('calibration_s.sim', rec) == 0.5
    ops = yardstick.work('resnet50', 224, 128)['ops'] / 128
    assert read('mfu.sim', rec) == pytest.approx(100 * ops * 3200 / 67e12)
    assert read('elementwise_ms.serving', rec) is None
    assert read('weight_pass_s.sim', record()) is None


def test_closed_loop_readers():
    rec = record(loop='closed', batch=8)
    assert read('request_p95_ms', rec) == pytest.approx(10.5)
    assert read('dispatch_ms.online', rec) == pytest.approx(7.0)
    assert read('kernels_per_request.online', rec) == pytest.approx(3.5)
    assert read('idle_share.online', rec) == pytest.approx(100 * (1 - 0.031 / 0.036))
    assert read('loop_device_ms.sweep', rec) is None


def test_untraced_run_reads_no_trace_metric():
    rec = record(traced=False)
    for name in ('idle_share.sweep', 'elementwise_ms.serving', 'int8_roofline.serving'):
        assert read(name, rec) is None
