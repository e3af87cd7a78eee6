"""Build the port's CUDA sources into shared libraries with a plain C
interface (nvcc by hand, loaded with ctypes).

``csrc/<name>.cu`` compiles into
``cnn_quantization_tpu_torch/_build/lib<name>-<hash>.so``, where the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing here runs at
import time; the kernel wrappers build at first use, one blocking nvcc call
per source; ``build_libraries`` starts several sources' calls together.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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


def build_libraries(names) -> dict[str, tuple[Path, str, float]]:
    """Build several sources at once, one nvcc process each, all started
    together; returns {name: (library path, nvcc output, seconds)}."""
    def timed(name):
        t0 = time.perf_counter()
        path, log = build_library(name)
        return path, log, time.perf_counter() - t0

    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))
