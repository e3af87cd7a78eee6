"""The streaming meters and ``cost_analysis``: the port against the JAX
package.

  * ``OnlineMeter``: the same float32 samples through both classes give
    equal mean, M2 and var (the same Welford update order in float32) and
    std within one ulp (PyTorch's vectorized CPU square root is not
    correctly rounded, numpy's is); the first update takes its shape;
    ``var`` is zero below two samples.
  * ``AccuracyMeter``: the same logits, with ties, give equal running top-k
    percentages (a stable sort breaks ties by class index, as
    ``jnp.argsort(-logits)`` does).
  * ``cost_analysis``: the flops of ``[128,256] @ [256,64]`` are 2·M·N·K
    exactly (JAX's test holds XLA's estimate within 50 %), and on one W8A8
    serving forward they equal ``count_work``'s operations.
"""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.utils import meters as j_meters

from cnn_quantization_tpu_torch.data.synthetic import synthetic_batches
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.utils.meters import AccuracyMeter, OnlineMeter
from cnn_quantization_tpu_torch.utils.profiling import cost_analysis, count_work


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('shape', [(4,), (3, 5), (1,)])
def test_online_meter_equals_jax(shape):
    xs = (np.random.RandomState(0).randn(9, *shape) * 3 + 1).astype(np.float32)
    got, want = OnlineMeter(), j_meters.OnlineMeter()
    for i, x in enumerate(xs):
        got.update(torch.from_numpy(x))
        want.update(x)
        assert got.mean.shape == shape and got.count == want.count == i + 1
        for name in ('mean', 'M2', 'var'):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                          err_msg=f'{name} after {i + 1} samples')
        np.testing.assert_array_max_ulp(got.std.numpy(), want.std, maxulp=1)
    assert got.mean.dtype == torch.float32 and torch.equal(got.val, torch.from_numpy(xs[-1]))


def test_online_meter_var_is_zero_below_two_samples():
    m = OnlineMeter()
    assert torch.equal(m.var, torch.zeros(1))
    m.update(torch.tensor([2.0, -1.0, 7.0]))
    assert torch.equal(m.var, torch.zeros(3))
    assert torch.equal(m.mean, torch.tensor([2.0, -1.0, 7.0]))


def test_accuracy_meter_with_ties_equals_jax():
    # rows 0-2 tie at the top: the lower class index ranks first in both
    logits = np.array([[0.5, 0.5, 0.1, 0.0],
                       [0.2, 0.7, 0.7, 0.7],
                       [0.3, 0.3, 0.3, 0.3],
                       [0.9, 0.1, 0.0, 0.0]], np.float32)
    labels = np.array([1, 2, 0, 3])
    got, want = AccuracyMeter(topk=(1, 2, 3)), j_meters.AccuracyMeter(topk=(1, 2, 3))
    for rows in (slice(None), slice(0, 3), slice(1, 2)):
        got.update(torch.from_numpy(logits[rows]), torch.from_numpy(labels[rows]))
        want.update(logits[rows], labels[rows])
        assert got.val == want.val and got.avg == want.avg and got.avg_error == want.avg_error
    assert got.avg[1] == 100.0 * 2 / 8   # top-1 hits: row 2's four-way tie, twice


def test_cost_analysis_matmul_flops():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    costs = cost_analysis(lambda x, y: x @ y, a, b)
    assert costs['flops'] == 2 * 128 * 256 * 64
    assert costs['bytes accessed'] == (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_cost_analysis_equals_count_work_on_a_w8a8_forward():
    model, meta = build_model('resnet18', device='cpu', seed=0, input_size=32)
    eng = QuantEngine(model, QuantPolicy(arch='resnet18', qtype='int8', qweight='int8'), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    calib, (images, _) = synthetic_batches(2, 2, size=32, seed=1)
    fwd = eng.make_forward(quantized='serving_int8',
                           act_scales=eng.freeze_serving_scales(sp, [calib], max_batches=1))
    costs = cost_analysis(fwd, sp, None, images)
    ops, nbytes = count_work(model, lambda: fwd(sp, None, images))
    assert costs['flops'] == ops > 0 and costs['bytes accessed'] == nbytes
