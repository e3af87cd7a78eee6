"""Calibration and the frozen path: the port against the JAX package.

Tolerances:
  * stats collected by the two packages on the same weights and images:
    1e-4 relative (the float activations differ by conv rounding, ~1e-6,
    and the higher moments amplify it), and 1e-4 absolute for kurtosis, an
    O(1) number whose zero crossings defeat a relative bound;
  * qparams frozen by both packages from ONE artifact: delta and offset
    within 1e-6 relative, qmax and the per-channel flag equal;
  * the port's frozen forward against its own dynamic use-stats forward:
    1e-6 per site, as tests/test_qparams.py asks of the JAX package, and the
    same predictions end to end.
"""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.calib import calibrator as j_cal
from cnn_quantization_tpu.engine import QuantEngine as JEngine
from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
from cnn_quantization_tpu.engine.qparams import discover_sites as j_discover_sites
from cnn_quantization_tpu.engine.qparams import freeze_qparams as j_freeze_qparams

from cnn_quantization_tpu_torch.calib import calibrator as cal
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.engine.context import QuantizeContext
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.engine.qparams import (apply_frozen, discover_sites,
                                                       freeze_qparams)
from cnn_quantization_tpu_torch.ops.quantizer import quantize_activation
from cnn_quantization_tpu_torch.utils.device import nhwc_to_nchw

from _torch_parity import POLICIES, CaptureContext, Pair

SIZE = 64


@pytest.fixture(scope='module')
def pair():
    return Pair('resnet18', SIZE)


@pytest.fixture(scope='module')
def batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(2, SIZE, SIZE, 3).astype(np.float32) * 2 - 1,
             rng.randint(0, 1000, 2).astype(np.int32)) for _ in range(2)]


@pytest.fixture(scope='module')
def collected(pair, batches):
    """Headline-recipe stats of the same weights and images, collected by
    each package: (jax_stats, torch_stats)."""
    policy = dict(POLICIES['headline'], arch='resnet18')
    j_eng = JEngine(pair.j_model, JPolicy(**policy), pair.j_meta)
    j_stats = j_cal.collect_statistics(j_eng.jit_collect(err_bits=4), pair.j_params, batches)
    eng = QuantEngine(pair.model, QuantPolicy(**policy), pair.meta)
    stats = cal.collect_statistics(eng.make_collect(err_bits=4), pair.params, batches)
    return j_stats, stats


def test_collected_stats_agree(collected):
    j_stats, stats = collected
    assert set(stats) == set(j_stats)
    for site, entry in j_stats.items():
        assert set(stats[site]) == set(entry), site
        for k, v in entry.items():
            atol = 1e-4 if k.endswith('kurtosis') else 1e-5
            np.testing.assert_allclose(stats[site][k], v, rtol=1e-4, atol=atol,
                                       err_msg=f'{site} {k}')


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_stats_artifact_interchange(pair, collected, tmp_path, writer):
    """An artifact written by either package loads in the other, and both
    freeze the same qparams from it."""
    j_stats, stats = collected
    path = str(tmp_path / 'stats.npz')
    if writer == 'jax':
        j_cal.save_stats(path, j_stats)
        loaded = cal.load_stats(path)
        j_loaded = j_stats
    else:
        cal.save_stats(path, stats)
        j_loaded = j_cal.load_stats(path)
        loaded = stats
    for site in loaded:
        for k in loaded[site]:
            np.testing.assert_array_equal(loaded[site][k], j_loaded[site][k])

    policy = dict(POLICIES['headline'], arch='resnet18')
    j_sites = j_discover_sites(pair.j_model, (1, SIZE, SIZE, 3))
    j_qp = j_freeze_qparams(JPolicy(**policy), j_loaded, j_sites)
    qp = QuantEngine(pair.model, QuantPolicy(**policy), pair.meta).freeze_qparams(
        loaded, input_shape=(1, SIZE, SIZE, 3))
    assert set(qp) == set(j_qp) and len(qp) == 23
    for site, want in j_qp.items():
        got = qp[site]
        assert got.per_channel == want.per_channel, site
        np.testing.assert_allclose(got.delta.numpy(), np.asarray(want.delta), rtol=1e-6,
                                   err_msg=site)
        np.testing.assert_allclose(got.offset.numpy(), np.asarray(want.offset), rtol=1e-6,
                                   atol=1e-7, err_msg=site)
        np.testing.assert_array_equal(np.broadcast_to(got.qmax.numpy(), np.shape(want.qmax)),
                                      np.asarray(want.qmax), err_msg=site)


FROZEN_POLICIES = {
    'headline': POLICIES['headline'],
    'naive8': dict(qtype='int8', qweight='int8', pcq_weights=True, pcq_act=True),
    'layerwise_aciq': dict(qtype='int4', qweight='int8', clipping='laplace'),
    'gaus2std': dict(qtype='int4', clipping='2std', pcq_act=True),
}


@pytest.mark.parametrize('name', sorted(FROZEN_POLICIES))
def test_frozen_matches_dynamic(pair, batches, name):
    policy = QuantPolicy(arch='resnet18', **FROZEN_POLICIES[name])
    eng = QuantEngine(pair.model, policy, pair.meta)
    stats = cal.collect_statistics(eng.make_collect(), pair.params, batches)
    pq = eng.quantize_params(pair.params)
    qp = eng.freeze_qparams(stats, input_shape=(1, SIZE, SIZE, 3))
    assert qp, 'no sites frozen'
    cap = CaptureContext()
    with torch.no_grad():
        torch.func.functional_call(pair.model, pq,
                                   (nhwc_to_nchw(batches[0][0], 'cpu'), cap))
    qctx = QuantizeContext(policy, stats=stats)
    for site_id, qparams in qp.items():
        site = next(s for s in pair.sites if s.id == site_id)
        cfg = qctx.config_for(site)
        dyn, _ = quantize_activation(cap.acts[site_id], cfg, half_range=site.half_range,
                                     site_stats=qctx.site_stats(site, cfg), tag=site.tag)
        fro = apply_frozen(cap.acts[site_id], qparams)
        np.testing.assert_allclose(fro.numpy(), dyn.numpy(), atol=1e-6, err_msg=site_id)

    dyn_logits, _ = eng.make_forward()(pq, stats, batches[0][0])
    fro_logits, _ = eng.make_forward(qparams=qp)(pq, stats, batches[0][0])
    assert float((dyn_logits - fro_logits).abs().mean()) < 0.3
    torch.testing.assert_close(dyn_logits.argmax(-1), fro_logits.argmax(-1))


def test_freeze_qparams_default_device_is_the_card(pair, collected, monkeypatch):
    """``device=None`` means the card: without one the call raises, and
    ``device='cpu'`` gives the engine's qparams."""
    _, stats = collected
    policy = QuantPolicy(arch='resnet18', **POLICIES['headline'])
    sites = discover_sites(pair.model, (1, 3, SIZE, SIZE))
    want = QuantEngine(pair.model, policy, pair.meta).freeze_qparams(
        stats, input_shape=(1, SIZE, SIZE, 3))
    got = freeze_qparams(policy, stats, sites, device='cpu')
    assert set(got) == set(want)
    for site, qp in got.items():
        assert qp.delta.device.type == 'cpu'
        torch.testing.assert_close(qp.delta, want[site].delta, atol=0, rtol=0)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        freeze_qparams(policy, stats, sites)


def test_evaluate_frozen_finite(pair, batches):
    policy = QuantPolicy(arch='resnet18', **POLICIES['headline'])
    eng = QuantEngine(pair.model, policy, pair.meta)
    stats = cal.collect_statistics(eng.make_collect(), pair.params, batches)
    qp = eng.freeze_qparams(stats, input_shape=(1, SIZE, SIZE, 3))
    res = evaluate(eng, eng.quantize_params(pair.params), batches, stats=stats, qparams=qp)
    assert 0.0 <= res['top1'] <= res['top5'] <= 100.0
    assert np.isfinite(res['loss']) and res['images_per_sec'] > 0
