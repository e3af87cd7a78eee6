"""Build the port's CUDA sources into shared libraries with a plain C
interface (nvcc by hand, loaded with ctypes).

``csrc/<name>.cu`` compiles into
``cnn_quantization_tpu_torch/_build/lib<name>-<hash>.so``, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time; the kernel
wrappers build at first use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
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
    src = CSRC_DIR / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
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
