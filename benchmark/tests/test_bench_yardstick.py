"""The frozen yardstick: multiply-accumulates against the papers' counts,
the bounds' arithmetic and the kernel classes."""

import json

import pytest

from benchmark import harness, yardstick

from .conftest import spec


@pytest.mark.parametrize('arch,gmacs', [('resnet50', 4.1), ('mobilenet_v2', 0.3)])
def test_macs_match_the_papers(arch, gmacs):
    w = yardstick.work(arch, 224, 1)
    assert w['ops'] / 2 / 1e9 == pytest.approx(gmacs, rel=0.01)


@pytest.mark.parametrize('config', spec()['configs'], ids=lambda c: c['name'])
def test_macs_match_the_configuration(config):
    """The walk at the configuration's own size counts the multiply-accumulates
    its file states (``macs_per_image``)."""
    data = json.loads((harness.HERE.parent / config['file']).read_text())
    assert yardstick.work(data['arch'], data['input_size'], 1)['ops'] == \
        2 * data['macs_per_image']


def test_bounds_scale_with_the_batch():
    one, many = yardstick.work('resnet50', 224, 1), yardstick.work('resnet50', 224, 128)
    assert many['ops'] == 128 * one['ops']
    # the weights are read once a batch, so the bound grows less than the batch
    assert one['int8_bound_s'] < many['int8_bound_s'] < 128 * one['int8_bound_s']
    assert many['fake_quant_bound_s'] == pytest.approx(128 * one['fake_quant_bound_s'])
    # ResNet-50 at batch 128: 1.05 TOP at the int8 peak is 0.53 ms, and the
    # int8 convs' bytes lift it above that
    assert 0.53e-3 < many['int8_bound_s'] < 5e-3


@pytest.mark.parametrize('name,cls', [
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::Tile<128>, cnnq::wg::DenseA, x>', 'int8_gemm'),
    ('void cnnq::wg::wgmma_kernel<cnnq::wg::ConvRing<128, 128>, cnnq::wg::Im2colA, x>',
     'int8_conv'),
    ('int8_depthwise_kernel', 'int8_conv'), ('fake_quant_kernel<float>', 'fake_quant'),
    ('void at::native::vectorized_elementwise_kernel<4, x>', 'elementwise'),
    ('Memcpy HtoD (Pinned -> Device)', 'memcpy'), ('cudnn_conv', 'other')])
def test_kernel_classes(name, cls):
    assert yardstick.kernel_class(name) == cls
