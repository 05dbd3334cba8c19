"""Build and bind the port's CUDA C++ kernels (csrc/*.cu).

At first use, `nvcc` compiles every source under `mixofshow_tpu_torch/csrc/`
for `sm_90a`, one process per source, all started together, and links the
objects into one shared library with a plain C interface, placed in
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

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / '.torch_ext'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-Xcompiler', '-fPIC')

# dtype codes of csrc/mma.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1

_c = ctypes
_ATTN_ARGS = ([_c.c_void_p] * 5 + [_c.c_int] * 6 + [_c.c_longlong] * 8
              + [_c.c_float, _c.c_int, _c.c_int, _c.c_void_p])
_GEMM_ARGS = ([_c.c_int] + [_c.POINTER(_c.c_void_p)] * 4
              + [_c.POINTER(_c.c_int)] * 3 + [_c.POINTER(_c.c_longlong)] * 2
              + [_c.POINTER(_c.c_float), _c.c_int, _c.c_void_p])
_REGION_ARGS = ([_c.c_void_p] * 6 + [_c.c_int] * 7
                + [_c.POINTER(_c.c_int), _c.c_float, _c.c_int, _c.c_void_p])
_FLASH_DKV_ARGS = ([_c.c_void_p] * 8 + [_c.c_int] * 5
                   + [_c.c_float, _c.c_int, _c.c_void_p])
_FLASH_DQ_ARGS = ([_c.c_void_p] * 7 + [_c.c_int] * 5
                  + [_c.c_float, _c.c_int, _c.c_void_p])
_CODES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}


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


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}):\n'
                          f'{" ".join(cmd)}\n{out}\n{err}')
    if failed:
        raise RuntimeError(failed[0])


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The output is written under a temporary name and renamed into place,
    so concurrent processes never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, f'{src.stem}.o') for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, '-I', str(CSRC_DIR), '-c', '-o', obj,
                   str(src)] for src, obj in zip(srcs, objs)])
        lib = os.path.join(tmpdir, 'lib.so')
        _run_all([[nvcc, '-shared', '-o', lib, *objs]])
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    lib.mos_attn_fwd.argtypes = _ATTN_ARGS
    lib.mos_attn_fwd.restype = ctypes.c_int
    lib.mos_gemm_grouped.argtypes = _GEMM_ARGS
    lib.mos_gemm_grouped.restype = ctypes.c_int
    lib.mos_region_attn.argtypes = _REGION_ARGS
    lib.mos_region_attn.restype = ctypes.c_int
    lib.mos_flash_bwd_dkv.argtypes = _FLASH_DKV_ARGS
    lib.mos_flash_bwd_dkv.restype = ctypes.c_int
    lib.mos_flash_bwd_dq.argtypes = _FLASH_DQ_ARGS
    lib.mos_flash_bwd_dq.restype = ctypes.c_int
    return lib


def device_type(*ts) -> str:
    """'cpu' or 'cuda', the one device all tensors lie on; raises otherwise."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError('all tensors must be on one device')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {dev}')
    return dev.type


def dtype_code(*ts) -> int:
    """The kernels' dtype code of tensors that share fp32 or bf16."""
    dt = ts[0].dtype
    if dt not in _CODES or any(t.dtype != dt for t in ts):
        raise TypeError(f'kernel takes one dtype of fp32/bf16 throughout, '
                        f'got {[t.dtype for t in ts]}')
    return _CODES[dt]


def stream(t) -> int:
    """The current CUDA stream of t's device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_only(what: str, *ts) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel
    has no backward, so its output would carry no gradient and the loss
    would silently lose that path. Checked on every device, so CPU runs
    see the same error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            f'{what} is forward-only (it has no backward kernel) but was '
            'called with grad mode on and an input that requires grad; '
            'wrap the call in torch.no_grad() or take a differentiable '
            'route (UNet fuse_attention=False)')


def check(rc: int, what: str) -> None:
    """Raise unless a kernel entry point returned 0 (cudaSuccess)."""
    if rc == -1:
        raise RuntimeError(f'{what}: the kernel refused its arguments')
    if rc != 0:
        raise RuntimeError(f'{what}: kernel launch failed, cudaError {rc}')
