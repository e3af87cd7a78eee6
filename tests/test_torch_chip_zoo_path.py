"""``chip_smoke.py``'s ``zoo_path`` phase rehearsed on the CPU at small sizes
and batch 2: every run, check and launch prediction of the phase, with
stand-ins for the kernels' launches (the plain version's result, counted in
the store by mode or route as the kernel's own wrapper counts).  On the card the phase
runs eight architectures at 224x224 (Inception-v3 at 299x299) and batch 32
through the kernels themselves."""

import pytest
import torch

import chip_smoke
from cnn_quantization_tpu_torch.cli import inference_sim
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils import counters


@pytest.fixture()
def stand_in_kernels(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    plain, plain_sem = fq.fake_quant_fused_plain, fq.fake_quant_kernel_semantics_plain

    def launch(x, p0, p1, qmax, channel_dim, mode, seed=0):
        counters.add('fake_quant')
        return x   # the result was computed by the plain version below

    def fused(x, delta, offset, qmax, *, channel_dim=None, stochastic=False, seed=0):
        out = plain(x, delta, offset, qmax, channel_dim=channel_dim, stochastic=stochastic,
                    seed=seed)
        return fq.launch(out, None, None, None, channel_dim,
                         fq.STOCHASTIC if stochastic else fq.AFFINE, seed)

    def semantics(x, delta, offset, num_bits):
        return fq.launch(plain_sem(x, delta, offset, num_bits), None, None, None, None, fq.MINMAX)

    def gemm_in(a, b, alpha, beta=None, **kw):
        counters.add('int8_gemm.' + im.gemm_route(a.shape[1]))
        return im.int8_matmul_dequant_plain(a, b, alpha, beta, **kw)

    def conv_in(x, w, alpha, bias=None, *, strides=(1, 1), padding=(0, 0), groups=1, **kw):
        counters.add('int8_conv.' + ic.conv_route(x.shape[1], w.shape[0], groups,
                                                  kernel=tuple(w.shape[2:]),
                                                  strides=tuple(strides), padding=tuple(padding)))
        return ic.int8_conv_dequant_plain(x, w, alpha, bias, strides=tuple(strides),
                                          padding=tuple(padding), groups=groups, **kw)

    monkeypatch.setattr(fq, 'launch', launch)
    monkeypatch.setattr(fq, 'fake_quant_fused', fused)
    monkeypatch.setattr(fq, 'fake_quant_kernel_semantics_fused', semantics)
    monkeypatch.setattr(im, 'int8_matmul_dequant', gemm_in)
    monkeypatch.setattr(ic, 'int8_conv_dequant', conv_in)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    real_main = inference_sim.main
    monkeypatch.setattr(inference_sim, 'main',
                        lambda argv: real_main(list(argv) + ['--device', 'cpu']))
    monkeypatch.delenv('IMAGENET_DIR', raising=False)
    yield
    torch.set_num_threads(n)


def test_zoo_path_phase_on_cpu(stand_in_kernels, capsys):
    sizes = {'vgg16': 32, 'inception_v3': 75, 'shufflenet': 32, 'squeezenet1_0': 64}
    launches = chip_smoke.zoo_path(torch.device('cpu'), 'cpu', archs=tuple(sizes)[1:], batch=2,
                                   sizes=sizes, held=2, cli=['--input_size', '32', '-b', '2',
                                                             '-ss', '4'])
    assert launches['fake_quant'] > 0 and launches['int8_gemm'] > 0 and launches['int8_conv'] > 0
    out = capsys.readouterr().out
    assert '"phase": "zoo_path"' in out
    report = chip_smoke.json.loads(next(ln for ln in out.splitlines()
                                        if '"phase": "zoo_path"' in ln))
    inc = report['archs']['inception_v3']
    # 94 convs (two 8-bit by name and the float stem among them), one classifier
    # 94 convs run: the float stem, 40 1x1 convs and the classifier as GEMMs,
    # 30 convs with C a multiple of 64 on the TMA im2col route (the 1x7/7x1
    # and 1x3/3x1 among them), 23 on the implicit GEMM
    assert inc['simulation']['sites'] == 95 and inc['serving']['gemm_per_forward'] == 41
    assert inc['serving']['routes_per_forward'] == {'wgmma': 41, 'im2col_wgmma': 30,
                                                    'implicit_gemm': 23}
    assert inc['simulation']['launches'] == inc['simulation']['predicted_launches']
    shuf = report['archs']['shufflenet']['serving']
    # 16 units: a depthwise 3x3 each, 31 grouped 1x1 convs, stage 2's first
    # 1x1 (K = 24) and the classifier as GEMMs
    assert shuf['routes_per_forward'] == {'depthwise': 16, 'implicit_gemm': 31,
                                          'mma_sync': 1, 'wgmma': 1}
    assert shuf['vector_scales'] == 47
    sq = report['archs']['squeezenet1_0']['serving']['routes_per_forward']
    # 16 1x1 convs and the conv classifier as GEMMs; the expand3x3 convs at C =
    # 64 (two) on the im2col route, at C = 16-48 (six) on the implicit GEMM
    assert sq == {'wgmma': 17, 'implicit_gemm': 6, 'im2col_wgmma': 2}
    cli = report['vgg16_cli']
    assert cli['launches'] == cli['predicted_launches'] and 0.0 < cli['avg_entropy'] <= 4.0
