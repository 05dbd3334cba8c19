"""Build and bind the port's CUDA C++ kernels (csrc/*.cu).

At first use, `nvcc` compiles every source under `mixofshow_tpu_torch/csrc/`
for `sm_90a` into one shared library with a plain C interface, placed in
`<repo>/.torch_ext/` under a name keyed by a hash of the sources and flags,
and loaded with ctypes. The sources include no PyTorch header, so the build
takes seconds; a later process with unchanged sources reuses the library.
Pointers and the stream are passed as Python ints (`tensor.data_ptr()`,
`torch.cuda.current_stream().cuda_stream`); every entry point returns a
cudaError_t code, which the wrappers turn into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / '.torch_ext'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-shared', '-Xcompiler', '-fPIC')

# dtype codes of csrc/mma.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1

_c = ctypes
_ATTN_ARGS = ([_c.c_void_p] * 4 + [_c.c_int] * 6 + [_c.c_longlong] * 8
              + [_c.c_float, _c.c_int, _c.c_void_p])
_GEMM_ARGS = ([_c.c_void_p] * 4 + [_c.c_int] * 3 + [_c.c_longlong] * 2
              + [_c.c_int, _c.c_void_p])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, 'bin', 'nvcc') if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which('nvcc')
    if path is None:
        raise RuntimeError('nvcc not found (CUDA_HOME unset and no nvcc on '
                           'PATH): the CUDA kernels cannot be built')
    return path


def _sources():
    return sorted(CSRC_DIR.glob('*.cu')), sorted(CSRC_DIR.glob('*.cuh'))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f'mos_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The output is written under a temporary name and renamed into place,
    so concurrent processes never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', tmp,
           *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    lib.mos_attn_fwd.argtypes = _ATTN_ARGS
    lib.mos_attn_fwd.restype = ctypes.c_int
    lib.mos_gemm_bias.argtypes = _GEMM_ARGS
    lib.mos_gemm_bias.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise unless a kernel entry point returned 0 (cudaSuccess)."""
    if rc == -1:
        raise RuntimeError(f'{what}: the kernel refused its arguments')
    if rc != 0:
        raise RuntimeError(f'{what}: kernel launch failed, cudaError {rc}')
