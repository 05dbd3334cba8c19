"""GroupNorm statistics: fp32 per-(batch, channel) Σx and Σx² over H×W.

Port of mixofshow_tpu/ops/gn_stats.py `spatial_sums` (K2). The TPU kernel
`_kernel` read an NHWC activation once in its storage dtype and carried fp32
accumulators across sequential row-tile grid steps. On the card the blocks
run in parallel and in no order, so the reduction takes two passes
(ops/gn_stats_triton.py): partial sums over slices of H×W, then a pass over
the partials — deterministic, with no atomics.

What bounds it: a pure bandwidth-bound reduction (read x once, 4 flops per
element); the Triton tiles issue coalesced vector loads along whichever of
H×W or C is contiguous.

The port keeps activations NCHW; the kernel reads the tensor's real strides
(contiguous or channels_last) and raises when H and W cannot be flattened.
Forward-only: with grad mode on, an input that requires grad raises (the
training path runs the VAE encode, its one caller, under no_grad).
"""
from __future__ import annotations

import torch

from mixofshow_tpu_torch.ops import _build


def spatial_sums_plain(x: torch.Tensor):
    """(B, C, H, W) -> fp32 ((B, C) sum, (B, C) sum of squares)."""
    xf = x.float()
    return xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))


def spatial_sums(x: torch.Tensor):
    """(B, C, H, W) -> fp32 ((B, C) sum, (B, C) sum of squares), reading x
    once in its storage dtype. CUDA tensors launch the Triton kernel; CPU
    tensors run `spatial_sums_plain`."""
    if x.dim() != 4:
        raise ValueError(f'spatial_sums takes (B, C, H, W), got {x.shape}')
    _build.forward_only('spatial_sums', x)
    if x.device.type == 'cpu':
        return spatial_sums_plain(x)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f'spatial_sums takes a float tensor, got {x.dtype}')
    if x.shape[2] > 1 and x.stride(2) != x.shape[3] * x.stride(3):
        raise ValueError(f'H and W must be flattenable, strides {x.stride()}')
    from mixofshow_tpu_torch.ops import gn_stats_triton
    out = gn_stats_triton.launch(x)
    spatial_sums.launches += 1
    return out


spatial_sums.launches = 0
