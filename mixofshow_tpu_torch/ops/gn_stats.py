"""GroupNorm's two kernels: the statistics (K2) and the apply (K8).

K2, `spatial_sums`: fp32 per-(batch, channel) Σx and Σx² over H×W. Port of
mixofshow_tpu/ops/gn_stats.py `spatial_sums`. The TPU kernel
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

K8, `scale_bias_act`: act(x·a + b) with per-(batch, channel) fp32 a, b and an
optional SiLU, GroupNorm's folded affine. Port of `_apply_kernel`
(mixofshow_tpu/ops/gn_stats.py:101, via `scale_bias_act` :139). The JAX
package left the apply to XLA, which fused it into its neighbours; eager
PyTorch runs it as separate multiply, add and SiLU passes, so the port routes
the VAE's GroupNorms (models/layers.group_norm, stats='kernel') through it.
What bounds it: one read and one write of every element, a and b loaded once
a (b, c) plane; no matrix product, so it is bandwidth-bound by two orders of
magnitude. The Triton kernel (ops/gn_stats_triton.py) gives each program one
plane's block of H×W, contiguous in NCHW, and forms x·a + b as the TPU kernel
does (a, b cast to the activation dtype first), the SiLU in fp32. The
backward is plain torch, the JAX package's `_apply_bwd` (it has no backward
kernel either).
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


# ------------------------------------------------------------------ apply
ACTS = ('none', 'silu')


def scale_bias_act_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         act: str = 'none'):
    """act(x * a + b): x (B, C, H, W), a and b (B, C) fp32 cast to x's dtype
    first; the SiLU in fp32, cast back."""
    dt = x.dtype
    y = x * a.to(dt)[:, :, None, None] + b.to(dt)[:, :, None, None]
    if act == 'silu':
        y32 = y.float()
        y = (y32 * torch.sigmoid(y32)).to(dt)
    return y


def _apply_bwd(x, a, b, act, g):
    """JAX `_apply_bwd` (gn_stats.py:151-164): (dx, da, db)."""
    dt = x.dtype
    af = a.to(dt)[:, :, None, None]
    gy = g
    if act == 'silu':
        y = (x * af + b.to(dt)[:, :, None, None]).float()
        sig = torch.sigmoid(y)
        gy = g * (sig * (1.0 + y * (1.0 - sig))).to(dt)
    dx = gy * af
    da = (gy.float() * x.float()).sum(dim=(2, 3))
    db = gy.sum(dim=(2, 3), dtype=torch.float32)
    return dx, da.to(a.dtype), db.to(b.dtype)


def _apply(x, a, b, act):
    if x.device.type == 'cpu':
        return scale_bias_act_plain(x, a, b, act)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'scale_bias_act takes fp32 or bf16, got {x.dtype}')
    if x.shape[2] > 1 and x.stride(2) != x.shape[3] * x.stride(3):
        raise ValueError(f'H and W must be flattenable, strides {x.stride()}')
    from mixofshow_tpu_torch.ops import gn_stats_triton
    out = gn_stats_triton.launch_apply(x, a, b, act == 'silu')
    scale_bias_act.launches += 1
    return out


class _ScaleBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, act):
        ctx.act = act
        ctx.save_for_backward(x, a, b)
        return _apply(x, a, b, act)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        return (*_apply_bwd(x, a, b, ctx.act, g), None)


def scale_bias_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   act: str = 'none'):
    """act(x * a + b) over (B, C, H, W) x with (B, C) fp32 a, b;
    differentiable in x, a and b. CUDA tensors launch the Triton kernel
    (K8); CPU tensors run `scale_bias_act_plain`."""
    if act not in ACTS:
        raise ValueError(f'act must be one of {ACTS}, got {act!r}')
    if x.dim() != 4 or a.shape != x.shape[:2] or b.shape != x.shape[:2]:
        raise ValueError(f'scale_bias_act takes x (B, C, H, W) and a, b '
                         f'(B, C); got {tuple(x.shape)}, {tuple(a.shape)}, '
                         f'{tuple(b.shape)}')
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f'a and b must be fp32, got {a.dtype}, {b.dtype}')
    if len({x.device, a.device, b.device}) != 1:
        raise ValueError('x, a and b must lie on one device')
    return _ScaleBiasAct.apply(x, a, b, act)


scale_bias_act.launches = 0
