"""KLD calibration of the port against the JAX package on the same seeded
numpy inputs.

Tolerances:
  * the numpy sweep: equal to the JAX package's numpy sweep (the same
    float64 arithmetic on the same histogram);
  * the port's C++ sweep: equal to the JAX package's within 1e-12 relative
    (one source; the JAX library is built with -march=native, which may
    contract a multiply-add in the bin-edge arithmetic).  The JAX package's
    library is compiled here, from its source and with its Makefile's flags,
    into the test's own directory: the package's on-demand build writes into
    its source tree, and a parallel test worker that loads a half-written
    file there turns the comparison into a skip;
  * C++ against numpy: within two bins of the histogram (2 * 2 * absmax /
    2001), the bar of tests/test_native_kld.py: the two bin the values with
    different arithmetic;
  * ``add_kld_thresholds`` on resnet18: per site within two bins of the
    site's largest per-image range, since the two packages' activations
    differ in the last bits and a value on a bin edge may change bins;
  * the KLD quantizer branch: bit-exact from the same statistics.
"""

import ctypes
import filecmp
import os
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_quantization_tpu.calib import kld as j_kld
from cnn_quantization_tpu.data.synthetic import synthetic_batches
from cnn_quantization_tpu.engine.qparams import SiteQParams as JSiteQParams
from cnn_quantization_tpu.engine.qparams import apply_frozen as j_apply_frozen
from cnn_quantization_tpu.ops import quantizer as j_q

from cnn_quantization_tpu_torch import native
from cnn_quantization_tpu_torch.calib import kld
from cnn_quantization_tpu_torch.calib.capture import make_capture_fn
from cnn_quantization_tpu_torch.engine.qparams import SiteQParams, apply_frozen
from cnn_quantization_tpu_torch.ops import quantizer as q
from cnn_quantization_tpu_torch.ops.kernels import build
from _torch_parity import JEngine, JPolicy, Pair, QuantEngine, QuantPolicy

REPO = pathlib.Path(__file__).resolve().parents[1]


def arrays():
    rng = np.random.RandomState(0)
    return {'laplace': rng.laplace(0, 1, 20000), 'normal': rng.normal(0, 2, 20000),
            'half_laplace': np.abs(rng.laplace(0, 1, 20000)),
            'skewed': rng.gamma(2.0, 1.0, 5000) - 1.0,
            'sparse': np.where(rng.rand(8000) < 0.9, 0.0, rng.randn(8000) * 3)}


def two_bins(arr):
    return 2 * 2 * float(np.abs(arr).max()) / 2001 + 1e-6


@pytest.mark.parametrize('name', list(arrays()))
def test_numpy_sweep_equals_jax(name):
    arr = arrays()[name].astype(np.float32)
    assert kld.kld_threshold(arr, use_native=False) == \
        j_kld.kld_threshold(arr, use_native=False)


# the JAX package's native/Makefile: CXXFLAGS and the link step
JAX_NATIVE_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall', '-shared')


@pytest.fixture(scope='module')
def jax_native(tmp_path_factory):
    """The JAX package's ``kld_threshold`` from its C++ source (read only),
    built with its Makefile's flags under a temporary name and renamed into
    place, loaded with ctypes as its binding loads it."""
    cxx = shutil.which(os.environ.get('CXX', 'g++')) or shutil.which('g++')
    assert cxx, 'a C++ compiler is needed (the port builds its own copy with g++ too)'
    out = tmp_path_factory.mktemp('jax_native') / 'libcnnq_native.so'
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    src = REPO / 'cnn_quantization_tpu' / 'native' / 'kld_threshold.cpp'
    subprocess.run([cxx, *JAX_NATIVE_FLAGS, '-o', str(tmp), str(src)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.kld_threshold.restype = ctypes.c_double
    lib.kld_threshold.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.parametrize('name', list(arrays()))
def test_native_sweep_equals_jax_native(name, jax_native):
    arr = np.ascontiguousarray(arrays()[name], np.float32)
    want = jax_native.kld_threshold(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    arr.size, 2001, 15)
    assert kld.kld_threshold(arr) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('name', list(arrays()))
def test_native_within_two_bins_of_numpy(name):
    arr = arrays()[name].astype(np.float32)
    assert abs(kld.kld_threshold(arr) - kld.kld_threshold(arr, use_native=False)) \
        <= two_bins(arr)


def test_batch_entry_point():
    """One threshold a row, equal to the single-array sweep of that row, for
    the C++ batch entry and for the numpy loop."""
    rng = np.random.RandomState(2)
    arr = (rng.laplace(0, 1, (4, 3000)) * np.arange(1, 5)[:, None]).astype(np.float32)
    got = kld.kld_threshold_batch(arr)
    assert got.shape == (4,) and got.dtype == np.float64
    np.testing.assert_array_equal(got, [native.kld_threshold_native(r) for r in arr])
    plain = kld.kld_threshold_batch(arr, use_native=False)
    np.testing.assert_array_equal(plain, [j_kld.kld_threshold(r, use_native=False)
                                          for r in arr])
    assert np.all(np.abs(got - plain) <= [two_bins(r) for r in arr])


def test_edge_cases_match_jax():
    zeros = np.zeros(100, np.float32)
    assert kld.kld_threshold(zeros) == 0.0 == j_kld.kld_threshold(zeros, use_native=False)
    assert kld.kld_threshold(zeros, use_native=False) == 0.0
    with pytest.raises(ValueError, match='batch, elems'):
        native.kld_threshold_batch_native(np.zeros(5, np.float32))


def test_source_is_a_verbatim_copy():
    assert filecmp.cmp(REPO / 'cnn_quantization_tpu_torch/csrc/kld_threshold.cpp',
                       REPO / 'cnn_quantization_tpu/native/kld_threshold.cpp', shallow=False)


def test_library_built_into_the_port_by_content_hash():
    path = build.build_host_library('kld_threshold')
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith('libkld_threshold-') and path.suffix == '.so'
    assert build.build_host_library('kld_threshold') == path   # reused, not rebuilt


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback to numpy: a source that does not compile raises with
    g++'s output, and the sweep raises with it."""
    (tmp_path / 'csrc').mkdir()
    (tmp_path / 'csrc' / 'kld_threshold.cpp').write_text('this is not C++;\n')
    monkeypatch.setattr(build, 'CSRC_DIR', tmp_path / 'csrc')
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for kld_threshold.cpp:\n.*error'):
        kld.kld_threshold(np.ones(10, np.float32))
    assert not list((tmp_path / '_build').glob('*.so'))


def test_failed_load_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'libkld_threshold-0.so'
    bad.write_bytes(b'not a shared library')
    monkeypatch.setattr(build, 'build_host_library', lambda name: bad)
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(OSError):
        kld.kld_threshold_batch(np.ones((2, 10), np.float32))


# ---------------------------------------------------------------- calibration

@pytest.fixture(scope='module')
def r18():
    return Pair('resnet18', 64)


def test_acts_to_host_rows_hold_each_image():
    """One row an image, whatever the memory format; a row's values are the
    image's (in NHWC order for channels_last)."""
    x = torch.randn(3, 4, 5, 6)
    cl = x.contiguous(memory_format=torch.channels_last)
    rows = kld.acts_to_host({'a': x, 'b': cl, 'c': torch.randn(3, 7)})
    assert rows['a'].shape == rows['b'].shape == (3, 120) and rows['c'].shape == (3, 7)
    for i in range(3):
        np.testing.assert_array_equal(rows['a'][i], x[i].reshape(-1).numpy())
        np.testing.assert_array_equal(rows['b'][i], x[i].permute(1, 2, 0).reshape(-1).numpy())


def test_add_kld_thresholds_matches_jax(r18):
    """Per batch the max over per-image thresholds, across batches
    min/mean/max, at every site; within two bins of JAX's."""
    batches = list(synthetic_batches(2, 3, size=64, seed=12345))
    j_eng = JEngine(r18.j_model, JPolicy(arch='resnet18', qtype='int4'), r18.j_meta)
    want = j_kld.add_kld_thresholds({}, j_eng, r18.j_params, batches, cal_set_size=4)
    eng = QuantEngine(r18.model, QuantPolicy(arch='resnet18', qtype='int4'), r18.meta)
    got = kld.add_kld_thresholds({'conv1_activation': {'scalar/mean_max': 1.0}}, eng,
                                 r18.params, batches, cal_set_size=4)
    assert got['conv1_activation']['scalar/mean_max'] == 1.0   # entries are added to
    assert sorted(got) == sorted(want) and len(got) == 23
    acts = make_capture_fn(eng)(r18.params, batches[0][0])
    for site, entry in want.items():
        bins = two_bins(acts[site].numpy())
        for kind in ('min', 'mean', 'max'):
            key = f'scalar/{kind}_kld_th'
            assert got[site][key].dtype == np.float32
            assert abs(float(got[site][key]) - float(entry[key])) <= bins, (site, key)
    # the numpy sweep gives the same thresholds within two bins
    plain = kld.add_kld_thresholds({}, eng, r18.params, batches[:1], use_native=False)
    one = kld.add_kld_thresholds({}, eng, r18.params, batches[:1])
    for site in ('conv0_activation', 'linear0_activation'):
        gap = float(plain[site]['scalar/max_kld_th']) - float(one[site]['scalar/max_kld_th'])
        assert abs(gap) <= two_bins(acts[site].numpy())


# ---------------------------------------------------------------- the quantizer

def kld_stats(x):
    a = np.abs(x)
    return {'mean_kld_th': np.float32(0.7 * a.max()), 'mean_max': np.float32(x.max()),
            'mean_min': np.float32(x.min()), 'mean_mean': np.float32(x.mean())}


@pytest.mark.parametrize('half', [False, True], ids=['sym', 'half_range'])
def test_kld_branch_matches_jax(half):
    """The dynamic KLD branch: alpha_to_delta_offset(kld_th, max, min, mean)
    through the reference-CUDA semantics, bit-exact against JAX."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 6, 8) * 2).astype(np.float32)
    st = kld_stats(x)
    cfg = dict(num_bits=4, kld=True)
    want, _ = j_q.quantize_activation(x, j_q.QuantConfig(**cfg), half_range=half, site_stats=st)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got, aux = q.quantize_activation(xt, q.QuantConfig(**cfg), half_range=half,
                                     site_stats={k: torch.tensor(v) for k, v in st.items()})
    assert aux == {}
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_kld_branch_needs_thresholds():
    x = torch.randn(2, 4, 6, 6)
    for stats in (None, {'mean_max': torch.tensor(1.0)}):
        with pytest.raises(ValueError, match='kld_th'):
            q.quantize_activation(x, q.QuantConfig(num_bits=4, kld=True), site_stats=stats)


def test_frozen_and_dynamic_kld_differ_as_in_jax():
    """A reference quirk kept on purpose: a frozen KLD site (affine form,
    rounded zero point) and a dynamic one (reference-CUDA semantics, the
    exact offset when the range does not straddle zero) differ for a range
    above zero, in the JAX package and in the port alike; each form equals
    its JAX counterpart."""
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 6, 6, 8) * 3 + 1.0).astype(np.float32)   # all above zero
    st = kld_stats(x)
    cfg = dict(num_bits=4, kld=True)
    j_dyn, _ = j_q.quantize_activation(x, j_q.QuantConfig(**cfg), site_stats=st)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    dyn, _ = q.quantize_activation(xt, q.QuantConfig(**cfg),
                                   site_stats={k: torch.tensor(v) for k, v in st.items()})
    np.testing.assert_array_equal(dyn.permute(0, 2, 3, 1).numpy(), np.asarray(j_dyn))
    # the frozen form, from the same (delta, offset)
    from cnn_quantization_tpu.ops.quant_math import alpha_to_delta_offset as j_a2d
    d, o = j_a2d(st['mean_kld_th'], st['mean_max'], st['mean_min'], st['mean_mean'],
                 half_range=False)
    assert float(o) > 0.0   # the range does not straddle zero
    j_fro = np.asarray(j_apply_frozen(x, JSiteQParams(d, o, jnp.float32(15.0), False)))
    fro = apply_frozen(xt, SiteQParams(torch.tensor(np.asarray(d)), torch.tensor(np.asarray(o)),
                                       torch.tensor(15.0), False))
    np.testing.assert_array_equal(fro.permute(0, 2, 3, 1).numpy(), j_fro)
    assert not np.array_equal(j_fro, np.asarray(j_dyn))
