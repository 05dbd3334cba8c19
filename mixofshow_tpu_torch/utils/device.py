"""Device and dtype policy of the port.

* Every entry point takes an explicit `device`; `as_device` refuses None, so
  nothing silently lands on the CPU.
* `require_cuda` is the one gate for code that must run on the card: it
  raises when no CUDA device is visible and never falls back.
* Compute runs in bf16 (`COMPUTE_DTYPE`) on the card; the DPM-Solver update
  keeps fp32 latents, as the reference's sampling scan does.
* `exact_fp32` turns TF32 off for matmuls and cuDNN convolutions: an fp32
  reference run on the card must not round to TF32's 10-bit mantissa
  (cuDNN convolutions use TF32 by default). `fp32_matmuls` does the same
  for the length of a block and restores what was set (gradient fusion).
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

COMPUTE_DTYPE = torch.bfloat16

DeviceLike = Union[str, torch.device]


def as_device(device: DeviceLike) -> torch.device:
    """Normalize an explicit device argument; None is an error, not CPU."""
    if device is None:
        raise ValueError('an explicit device is required (e.g. "cuda" or '
                         '"cpu")')
    return torch.device(device)


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible '
                           '(torch.cuda.is_available() is False)')
    return torch.device('cuda', 0)


def exact_fp32() -> None:
    """Disable TF32 for matmuls and cuDNN convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def fp32_matmuls():
    """Full fp32 matmuls and convolutions inside the block, whatever the
    process has set, restored after it: the fusion's grams, G @ ΔW products
    and eigh inputs must not round to TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
