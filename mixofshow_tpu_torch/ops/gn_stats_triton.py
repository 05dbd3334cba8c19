"""Triton kernels behind ops.gn_stats: spatial_sums (K2) and scale_bias_act
(K8).

Imported only by those wrappers when they are given a CUDA tensor: this
module imports triton, which only the machine with the card has.

Triton caches its compiled kernels under `<repo>/.torch_ext/triton` unless
TRITON_CACHE_DIR says otherwise, so the port writes nothing outside its
checkout.

Pass 1 (`_partial_kernel`): program (b, channel block, H×W slice) reduces a
[BLOCK_C, BLOCK_HW] tile at a time into fp32 Σx, Σx², one partial per slice.
Pass 2 (`_finish_kernel`): sums the slices' partials in a fixed order.

K8 (`_apply_kernel`): program (plane b·C + c, block of H×W) loads that
plane's a and b once as scalars, then BLOCK elements of x with one vector
load (contiguous along H×W in NCHW), and stores act(x·a + b) at the same
strides. a and b are cast to x's dtype first (JAX gn_stats.py:107-109);
x·a and then + b each round to x's dtype, as the TPU kernel's two
activation-dtype operations and the plain twin do; the SiLU is fp32, then
cast (:110-114). In bf16 those roundings are integer arithmetic on the fp32
bits (`_round_bf16`): Triton folds a bf16 cast followed by an fp32 cast into
nothing, which would leave one rounding where the twin has two.
"""
from __future__ import annotations

import functools
import os

import torch

from mixofshow_tpu_torch.ops._build import BUILD_DIR

os.environ.setdefault('TRITON_CACHE_DIR', str(BUILD_DIR / 'triton'))

import triton  # noqa: E402
import triton.language as tl  # noqa: E402


@triton.jit
def _partial_kernel(x_ptr, part_ptr, C, HW, chunk, n_split,
                    stride_b, stride_c, stride_hw,
                    BLOCK_C: tl.constexpr, BLOCK_HW: tl.constexpr):
    b = tl.program_id(0)
    cb = tl.program_id(1)
    sp = tl.program_id(2)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    c_mask = offs_c < C
    start = sp * chunk
    base = x_ptr + b * stride_b + offs_c[:, None] * stride_c
    acc_s = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc_q = tl.zeros([BLOCK_C], dtype=tl.float32)
    for i in range(0, chunk, BLOCK_HW):
        offs_hw = start + i + tl.arange(0, BLOCK_HW)
        mask = c_mask[:, None] & (offs_hw[None, :] < HW)
        x = tl.load(base + offs_hw[None, :] * stride_hw, mask=mask,
                    other=0.0).to(tl.float32)
        acc_s += tl.sum(x, axis=1)
        acc_q += tl.sum(x * x, axis=1)
    out = part_ptr + (b * n_split + sp) * 2 * C + offs_c
    tl.store(out, acc_s, mask=c_mask)
    tl.store(out + C, acc_q, mask=c_mask)


@triton.jit
def _finish_kernel(part_ptr, s_ptr, q_ptr, C, n_split,
                   BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    offs_c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    mask = offs_c < C
    acc_s = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc_q = tl.zeros([BLOCK_C], dtype=tl.float32)
    for sp in range(0, n_split):
        p = part_ptr + (b * n_split + sp) * 2 * C + offs_c
        acc_s += tl.load(p, mask=mask, other=0.0)
        acc_q += tl.load(p + C, mask=mask, other=0.0)
    tl.store(s_ptr + b * C + offs_c, acc_s, mask=mask)
    tl.store(q_ptr + b * C + offs_c, acc_q, mask=mask)


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(x: torch.Tensor):
    """Σx, Σx² over H×W of a (B, C, H, W) CUDA tensor with flattenable H, W."""
    bsz, c, h, w = x.shape
    hw = h * w
    stride_hw = x.stride(3) if w > 1 else x.stride(2)
    # tile along whichever axis is contiguous: H×W for NCHW, C for NHWC
    if stride_hw == 1:
        block_c, block_hw = 8, 512
    else:
        block_c, block_hw = 64, 64
    n_cb = triton.cdiv(c, block_c)
    n_sm = _num_sms(x.device)
    n_split = max(1, min(triton.cdiv(hw, block_hw),
                         triton.cdiv(4 * n_sm, bsz * n_cb)))
    chunk = triton.cdiv(triton.cdiv(hw, n_split), block_hw) * block_hw
    n_split = triton.cdiv(hw, chunk)

    part = torch.empty((bsz, n_split, 2, c), dtype=torch.float32,
                       device=x.device)
    s = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    q = torch.empty_like(s)
    with torch.cuda.device(x.device):
        _partial_kernel[(bsz, n_cb, n_split)](
            x, part, c, hw, chunk, n_split, x.stride(0), x.stride(1),
            stride_hw, BLOCK_C=block_c, BLOCK_HW=block_hw, num_warps=4)
        _finish_kernel[(bsz, triton.cdiv(c, 128))](
            part, s, q, c, n_split, BLOCK_C=128, num_warps=4)
    return s, q


@triton.jit
def _round_bf16(y):
    """fp32 -> the nearest bf16 value, ties to even, kept in fp32."""
    u = y.to(tl.uint32, bitcast=True)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.to(tl.float32, bitcast=True)


@triton.jit
def _apply_kernel(x_ptr, a_ptr, b_ptr, o_ptr, C, HW,
                  stride_b, stride_c, stride_hw,
                  SILU: tl.constexpr, BF16: tl.constexpr,
                  BLOCK: tl.constexpr):
    plane = tl.program_id(0)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < HW
    a = tl.load(a_ptr + plane)
    b = tl.load(b_ptr + plane)
    base = (plane // C) * stride_b + (plane % C) * stride_c
    x = tl.load(x_ptr + base + offs * stride_hw, mask=mask,
                other=0.0).to(tl.float32)
    if BF16:
        y = _round_bf16(_round_bf16(x * _round_bf16(a)) + _round_bf16(b))
    else:
        y = x * a + b
    if SILU:
        y = y * tl.sigmoid(y)
    tl.store(o_ptr + base + offs * stride_hw,
             y.to(o_ptr.dtype.element_ty), mask=mask)


APPLY_BLOCK = 1024


def launch_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 silu: bool):
    """act(x·a + b) of a (B, C, H, W) fp32 or bf16 CUDA tensor with
    flattenable H, W and (B, C) fp32 a, b; the output has x's strides."""
    bsz, c, h, w = x.shape
    hw = h * w
    stride_hw = x.stride(3) if w > 1 else x.stride(2)
    out = torch.empty_like(x)
    if out.stride() != x.stride():
        raise ValueError(f'cannot mirror the strides {x.stride()}')
    a, b = a.contiguous(), b.contiguous()
    with torch.cuda.device(x.device):
        _apply_kernel[(bsz * c, triton.cdiv(hw, APPLY_BLOCK))](
            x, a, b, out, c, hw, x.stride(0), x.stride(1), stride_hw,
            SILU=silu, BF16=x.dtype == torch.bfloat16, BLOCK=APPLY_BLOCK,
            num_warps=4)
    return out
