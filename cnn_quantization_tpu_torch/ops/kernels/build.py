"""Build the port's CUDA sources into shared libraries with a plain C
interface (nvcc by hand, loaded with ctypes).

``csrc/<name>.cu`` compiles into
``cnn_quantization_tpu_torch/_build/lib<name>-<hash>.so``, where the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing here runs at
import time; the kernel wrappers build at first use, one blocking nvcc call
per source; ``build_libraries`` starts several sources' calls together.

``build_host_library`` does the same for a host C++ source, ``csrc/<name>.cpp``,
with the host compiler (the KLD calibration sweep; no device code).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ...utils import spans

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels.
# --fmad=false: no contraction of a*b+c into an FMA, which rounds differently
# from PyTorch's separate ops; never --use_fast_math (true division, rintf).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to build '
                       'the port\'s kernels')


# the flags of the JAX package's native/Makefile, without -march=native (the
# library is built where it runs, but need not be tuned to that CPU)
HOST_CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-shared')


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build_library(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless it is built already; return the
    library's path and nvcc's output (ptxas register and spill reports; empty
    when the library was reused).  Raises with nvcc's output if it fails."""
    out = library_path(name)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{proc.stdout}')
    os.replace(tmp, out)
    return out, proc.stdout


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f'{name}.cpp').read_bytes())
    digest.update(' '.join(HOST_CXX_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build_host_library(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` unless it is
    built already; return the library's path.  Raises with the compiler's
    output if it fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError(f'g++ not found: the host compiler is needed to build {name}.cpp')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([cxx, *HOST_CXX_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cpp')],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed for {name}.cpp:\n{proc.stdout}')
    os.replace(tmp, out)
    return out


def build_libraries(names) -> dict[str, tuple[Path, str, float]]:
    """Build several sources at once, one nvcc process each, all started
    together; returns {name: (library path, nvcc output, seconds)}.  The
    ``kernels.load`` span holds one ``kernels.load.<name>`` span a library,
    which counts whether nvcc ran (``built``) or found it built."""
    def timed(name):
        built = not library_path(name).exists()
        t0 = time.perf_counter_ns()
        path, log = build_library(name)
        return path, log, t0, time.perf_counter_ns(), built

    names = list(names)
    with spans.span('kernels.load') as top:
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
            done = dict(zip(names, pool.map(timed, names)))
    for name, (_, _, t0, t1, built) in done.items():
        spans.add(f'kernels.load.{name}', t0, t1, parent=top, counts={'built': int(built)})
    return {name: (path, log, (t1 - t0) / 1e9) for name, (path, log, t0, t1, _) in done.items()}
