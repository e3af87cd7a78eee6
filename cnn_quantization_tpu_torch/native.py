"""Native (C++) host component: the KLD calibration threshold sweep.

Port of ``cnn_quantization_tpu/native/__init__.py``.  The source is the
port's own copy, ``csrc/kld_threshold.cpp``, built with the host compiler at
first use into ``_build/`` (``ops/kernels/build.build_host_library``) and
bound with ctypes.  It runs on the host in both packages: it is no TPU
kernel and has no device counterpart.

Unlike the JAX package, which falls back to its numpy sweep when the library
is missing, a failed build or load raises here; ``calib/kld.py`` reaches its
numpy sweep only when the caller asks for it (``use_native=False``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .ops.kernels import build

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build_host_library('kld_threshold')))
        c_float_p, c_double_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
        lib.kld_threshold.restype = ctypes.c_double
        lib.kld_threshold.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.kld_threshold_batch.restype = None
        lib.kld_threshold_batch.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int, c_double_p]
        _lib = lib
    return _lib


def kld_threshold_native(arr, num_bins: int = 2001, num_quantized_bins: int = 15) -> float:
    """The C++ sweep's threshold for the values of ``arr`` (any shape)."""
    lib = _library()
    a = np.ascontiguousarray(arr, np.float32).ravel()
    return float(lib.kld_threshold(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   a.size, num_bins, num_quantized_bins))


def kld_threshold_batch_native(arr2d, num_bins: int = 2001,
                               num_quantized_bins: int = 15) -> np.ndarray:
    """One threshold per row of a [batch, elems] array (float64)."""
    lib = _library()
    a = np.ascontiguousarray(arr2d, np.float32)
    if a.ndim != 2:
        raise ValueError(f'expected a [batch, elems] array, got shape {a.shape}')
    out = np.zeros(a.shape[0], np.float64)
    lib.kld_threshold_batch(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            a.shape[0], a.shape[1], num_bins, num_quantized_bins,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
