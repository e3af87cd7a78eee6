"""The port's throughput bench and its roofline accounting, on the CPU.

``RooflineReport`` is held to the JAX package's dataclass on the same numbers;
the counted operations of resnet18 at 64x64 to a hand sum of 2 x MACs over its
convs and its classifier, and the counted bytes to the rule (each kernel's
operands and output once) on a single layer.  The bench itself runs end to end
on ``device='cpu'`` at resnet18, batch 2, 64x64 (plain versions of the
kernels, small probes): the last line must be one short JSON object with the
reference's keys, every value finite, every share of a peak at most 1; a
failing section must end it with a non-zero exit code and the section's name.
Times from such a run say nothing about the card and are not looked at.
"""

import json
import math

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.utils.profiling import RooflineReport as JRooflineReport

from cnn_quantization_tpu_torch import bench
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy, TapContext
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils import counters, profiling
from cnn_quantization_tpu_torch.utils.device import nhwc_to_nchw

SIZE = 64
KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'w4a4_sim_images_per_sec', 'w4a4_sim_vs_bf16',
        'bf16_images_per_sec', 'w4a4_serving_images_per_sec', 'w4a4_packed_images_per_sec',
        'mfu_int8', 'bandwidth_util', 'mfu_ceiling_mem', 'bound', 'bytes_counted',
        'w4a4_packed_mfu_int8', 'w4a4_packed_bytes_counted', 'w4a4_packed_mfu_ceiling_mem',
        'int8_resident_offenders', 'batch_sweep', 'serving_ips_spread',
        'mobilenet_serving_images_per_sec', 'mobilenet_per_channel_act_sites', 'int8_dot_tops',
        'int8_dot_mfu', 'dma_copy_gbps', 'dma_probe_sane', 'mfu_ceiling_mem_practical',
        'cuda_stochastic_ok')
PROBES = dict(probe_gemm=(64, 256, 64), probe_rows=2048)   # small: times are not looked at
SHARES = ('mfu_int8', 'bandwidth_util', 'w4a4_packed_mfu_int8', 'int8_dot_mfu',
          'int8_gemm_kernel_mfu')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """PyTorch on one thread: the plain int32 grouped convolution of the CPU
    is slow, and under a parallel test run its OpenMP barriers wait on
    descheduled threads for minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('numbers', [
    dict(flops_per_call=8.2e9, bytes_per_call=3.1e8, calls_per_sec=40.0, peak_flops=1979e12,
         peak_bw=3.35e12),
    dict(flops_per_call=1e12, bytes_per_call=1e6, calls_per_sec=900.0, peak_flops=989e12,
         peak_bw=3.35e12),
    dict(flops_per_call=5e9, bytes_per_call=0.0, calls_per_sec=10.0, peak_flops=2e12,
         peak_bw=50e9)])
def test_roofline_report_equals_the_jax_dataclass(numbers):
    kw = dict(numbers, achieved_flops=numbers['flops_per_call'] * numbers['calls_per_sec'],
              achieved_bw=numbers['bytes_per_call'] * numbers['calls_per_sec'])
    got, want = profiling.RooflineReport(**kw), JRooflineReport(**kw)
    for prop in ('compute_util', 'bandwidth_util', 'bound', 'mem_roofline_mfu'):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.bound in str(got)


def test_device_peaks_have_no_tpu_row():
    assert set(profiling.PEAKS) == {'h100', 'cpu'}
    assert profiling.device_peaks('cpu') is profiling.PEAKS['cpu']
    assert profiling.PEAKS['h100']['int8_ops'] == 1979e12
    assert profiling.PEAKS['h100']['hbm_gbps'] == 3.35e12


def test_device_peaks_refuse_an_unknown_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda dev=None: 'Some Other Card')
    with pytest.raises(ValueError, match='no peak rates known'):
        profiling.device_peaks('cuda')
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda dev=None: 'NVIDIA H100 80GB HBM3')
    assert profiling.device_peaks('cuda') is profiling.PEAKS['h100']


def test_module_inputs_tell_codes_from_floats(r18):
    """The hand-off walk behind ``int8_resident_offenders``: dynamic serving
    hands every module floats; nothing at 64x64 is wide."""
    model, meta, x = r18
    eng = QuantEngine(model, QuantPolicy(arch='resnet18', qtype='int8', qweight='int8'), meta)
    sp = eng.prepare_serving_params(dict(model.state_dict()))
    fwd = eng.make_forward(quantized='serving_int8')
    seen = bench.module_inputs(model, lambda: fwd(sp, None, x))
    assert len(seen) == 20 + 1 + 2   # convs, the classifier, the two pools
    assert {kind for _, kind, _, _ in seen} == {'float'}
    scales = eng.freeze_serving_scales(sp, [(x, np.zeros(2, np.int32))])
    frozen = eng.make_forward(quantized='serving_int8', act_scales=scales)
    kinds = {type(m).__name__: kind for m, kind, _, _ in
             bench.module_inputs(model, lambda: frozen(sp, None, x))}
    assert kinds['QMaxPool'] == 'codes'   # the int8-resident flow pools codes
    assert bench.wide_float_handoffs(model, lambda: frozen(sp, None, x), x.size) == 0


@pytest.fixture(scope='module')
def r18():
    model, meta = build_model('resnet18', device='cpu')
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    return model, meta, x


def _hand_ops(model, x):
    """2 x MACs of every conv and linear, from output shapes seen by hooks."""
    total, hooks = [0], []

    def hook(mod, _args, out):
        if isinstance(mod, QConv):
            n, _, h, w = out.shape
            total[0] += 2 * n * h * w * mod.features * (mod.in_ch // mod.groups) \
                * mod.weight.shape[2] * mod.weight.shape[3]
        else:
            total[0] += 2 * out.shape[0] * mod.weight.shape[0] * mod.weight.shape[1]

    for m in model.modules():
        if isinstance(m, (QConv, QLinear)):
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model(nhwc_to_nchw(x, 'cpu'), TapContext())
    for h in hooks:
        h.remove()
    return total[0]


def test_counted_operations_equal_a_hand_sum(r18):
    model, meta, x = r18
    want = _hand_ops(model, x)
    # the stem by hand: 2 images, 32x32 outputs, 64 filters of 3x7x7
    assert want > 2 * 2 * 32 * 32 * 64 * 3 * 7 * 7
    params = dict(model.state_dict())
    eng = QuantEngine(model, QuantPolicy(arch='resnet18', qtype='int8', qweight='int8'), meta)
    fwd = eng.make_forward(quantized=False)
    ops, nbytes = profiling.count_work(model, lambda: fwd(params, None, x))
    assert ops == want and nbytes > 0
    # the same work whatever carries it: the serving forward counts the same operations
    sp = eng.prepare_serving_params(params)
    serve = eng.make_forward(quantized='serving_int8')
    before = counters.snapshot()
    ops_s, bytes_s = profiling.count_work(model, lambda: serve(sp, None, x))
    assert ops_s == want and bytes_s > 0
    # the CPU launches nothing
    assert counters.by_kernel(counters.since(before))['int8_gemm'] == 0
    assert im.int8_matmul_dequant.__name__ == 'int8_matmul_dequant'   # the wrapper is back
    rep = profiling.roofline_report(model, lambda: serve(sp, None, x), calls_per_sec=3.0,
                                    int8=True, device='cpu')
    assert rep.flops_per_call == want and rep.bytes_per_call == bytes_s
    assert 0 < rep.compute_util <= 1 and 0 < rep.bandwidth_util <= 1
    with pytest.raises(ValueError, match='share of a peak above 1'):
        profiling.roofline_report(model, lambda: serve(sp, None, x), calls_per_sec=1e9,
                                  int8=True, device='cpu')


def test_counted_bytes_of_one_kernel_call_and_one_pass():
    """A kernel wrapper counts its operands and its output once, whatever its
    plain version moves inside; an elementwise pass its input and output; a
    view nothing."""
    a = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    b = torch.randint(-127, 128, (32, 16), dtype=torch.int8)
    alpha, beta = torch.rand(16), torch.rand(16)
    x = torch.rand(8, 4)

    def work():
        im.int8_matmul_dequant(a, b, alpha, beta)
        torch.relu(x.view(4, 8).t())

    _, nbytes = profiling.count_work(torch.nn.Identity(), work)
    assert nbytes == (64 * 32 + 32 * 16 + 4 * 16 + 4 * 16 + 4 * 64 * 16) + 2 * 4 * 32


@pytest.fixture(scope='module')
def bench_run():
    """One run of the bench's ``main`` on the CPU; (exit code, stdout lines)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(arch='resnet18', batch=2, size=SIZE, sweep=(1,), device='cpu', **PROBES)
    return rc, out.getvalue().strip().splitlines()


def test_bench_main_ends_with_one_short_json_line(bench_run):
    rc, lines = bench_run
    assert rc == 0
    assert lines[0] == 'cpu'   # where a card's nvidia-smi name and power limit stand
    head = json.loads(lines[-1])
    assert len(lines[-1]) < 2500 and 'per_op_top' not in head
    missing = [k for k in KEYS if k not in head]
    assert not missing, missing
    assert head['metric'] == 'resnet18_int8_serving_images_per_sec_per_chip'
    assert head['device'] == 'cpu' and head['batch'] == 2 and head['dtype'] == 'bfloat16'
    numbers = {k: v for k, v in head.items() if isinstance(v, (int, float))
               and not isinstance(v, bool)}
    numbers.update({f'sweep_{k}': v for k, v in head['batch_sweep'].items()})
    numbers.update({f'spread_{k}': v for k, v in head['serving_ips_spread'].items()})
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    for k in SHARES:
        assert 0 <= head[k] <= 1, (k, head[k])
    assert set(head['batch_sweep']) == {'1', '2'}
    s = head['serving_ips_spread']
    assert s['min'] <= s['median'] <= s['max'] and s['min'] <= head['value'] + 0.1 <= s['max'] + 0.2
    assert head['mobilenet_per_channel_act_sites'] == 17
    assert head['cuda_stochastic_ok'] is True and head['dma_probe_sane'] is True
    assert head['bound'] in ('compute', 'memory')
    # without a card there is no device trace: no idle share is made up
    assert head['serving_idle_share'] is None and head['w4a4_packed_idle_share'] is None


def test_bench_sections_print_before_the_headline(bench_run):
    _, lines = bench_run
    sections = [json.loads(ln)['section'] for ln in lines[1:-1]]
    assert sections == ['forwards', 'per_op_top', 'batch_sweep', 'mobilenet_serving', 'probes',
                        'kernel_launches']
    forwards = json.loads(lines[1])
    assert {'w4a4_sim', 'bf16', 'serving', 'w4a4_serving', 'w4a4_packed'} <= set(forwards)
    launches = json.loads(lines[-2])
    # on the CPU every wrapper runs its plain version: no launch is counted
    assert all(v == 0 for sec in launches.values() if isinstance(sec, dict) for v in sec.values())


def test_bench_failing_section_exits_non_zero(monkeypatch, capsys):
    def broken(device):
        raise RuntimeError('probe fell over')

    monkeypatch.setattr(bench, '_stochastic_smoke', broken)
    rc = bench.main(arch='resnet18', batch=2, size=SIZE, sweep=(), device='cpu', **PROBES)
    captured = capsys.readouterr()
    assert rc == 1
    assert 'bench FAILED in section stochastic_smoke: RuntimeError: probe fell over' in captured.err
    last = captured.out.strip().splitlines()[-1]
    assert 'metric' not in last   # no headline after a failure


def test_bench_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(arch='resnet18', batch=2, size=SIZE)


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / 'trace.json'
    with profiling.trace(str(path)) as where:
        torch.relu(torch.randn(64, 64))
    assert where == str(path)
    events = json.loads(path.read_text())['traceEvents']
    assert any('relu' in str(e.get('name', '')) for e in events)
    assert profiling.per_op_profile(lambda: None) is None   # no card, no device profile
