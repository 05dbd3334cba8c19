"""Attention kernels of the sampling path and their plain twins.

Port of mixofshow_tpu/ops/fused_attention.py:

  * `attn_fwd` (K1, csrc/attn_fwd.cu) replaces `_packed_fwd_kernel`: the
    attention forward of UNet self-attention with >= 1024 keys. The TPU
    version ran on q/k/v whose heads were zero-padded to 128 lanes in HBM;
    the port's projections produce the natural (B, S, H, D) layout and the
    kernel pads D only inside its shared-memory tiles. For bf16 heads up to
    160 wide it is a wgmma kernel shared with K4 (`flash_fwd`) in two
    designs: up to D 80 a producer warp keeps a TMA ring of K/V tiles full
    for two or three consumer warpgroups that take turns at the tensor cores
    (ping-pong); wider heads, and heads TMA cannot read, go to two
    warpgroups that share each K/V tile of a cp.async ring in lock-step.
    `flash_attention.fwd_route` picks the design; `attn_fwd.routes` counts
    launches by design. In both, P stays in registers as the A operand of
    P·V, and the next tile's logits are in flight while this tile's softmax
    runs. The scale is folded into q before the bf16 rounding, as the TPU
    kernel did.
    `attention_packed` is the processor around it: the q/k/v/out projections
    stay plain `F.linear` products, as the JAX package left them to XLA.
    Its bf16 heads wider than 160 (up to 512) run csrc/attn_wide.cu, the
    wgmma core built for K3.
  * `attention_block` (K3) replaces `_kernel`, the whole attention processor
    of the VAE mid-block (one 512-wide head): the q, k and v projections with
    biases in one grouped wgmma GEMM launch (csrc/gemm_hopper.cu), 1/√D
    folded into q after its bias and before the bf16 rounding as the TPU
    kernel did; the attention core with scale 1 (csrc/attn_wide.cu for heads
    wider than 160, the attn_fwd core below that); the out-projection plus
    bias (the same GEMM, one triple). Three launches, one call.

Weights use the PyTorch layout, (out, in). Each wrapper runs its plain
version for CPU tensors and launches its kernel for CUDA tensors; there is
no fallback between the two. `<wrapper>.launches` counts kernel launches.
Both kernels are forward-only: with grad mode on, an input that requires
grad raises (on either device) rather than return an output without a
gradient; training takes ops.flash_attention.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops.flash_attention import (WIDE_MAX_HEAD_DIM,
                                                     count_route, launch_fwd,
                                                     scaled_q)

NEG_INF = -1e30


# ----------------------------------------------------------- plain versions
def attn_fwd_plain(q, k, v, kv_len: Optional[int] = None):
    """softmax(q̃ kᵀ) v over (B, S, H, D) in fp32, q̃ = q / √D rounded to
    q's dtype first (the kernel's order and the TPU kernel's), keys >=
    kv_len masked; returned in q's dtype."""
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    logits = torch.einsum('bqhd,bkhd->bhqk', scaled_q(q), k.float())
    if kv_len < sk:
        logits[..., kv_len:] = NEG_INF
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v.float()).to(q.dtype)


def attention_block_plain(x, ctx, wq, wk, wv, wo, bias, heads: int,
                          bias_q=None, bias_k=None, bias_v=None):
    """The whole attention processor in fp32: to_out(softmax(x wqᵀ (ctx
    wkᵀ)ᵀ / √D) (ctx wvᵀ)); returned in x's dtype."""
    def lin(t, w, b):
        return F.linear(t.float(), w.float(), None if b is None else b.float())

    b, sq, c = x.shape
    d = c // heads
    q = lin(x, wq, bias_q).view(b, sq, heads, d)
    k = lin(ctx, wk, bias_k).view(b, -1, heads, d)
    v = lin(ctx, wv, bias_v).view(b, -1, heads, d)
    o = attn_fwd_plain(q, k, v)
    return lin(o.reshape(b, sq, c), wo, bias).to(x.dtype)


# ------------------------------------------------------------------ launches
_GEMM_COLUMNS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
                 + (ctypes.c_longlong,) * 2 + (ctypes.c_float,))


def _gemm_grouped(triples):
    """Launch csrc/gemm_hopper.cu once over up to three (x2d, w, bias,
    scale) triples: each (M, K) · (N, K)ᵀ + bias, times scale -> a new
    (M, N) tensor. Every argument is checked before the launch."""
    if not 1 <= len(triples) <= 3:
        raise ValueError(f'gemm_grouped takes 1 to 3 triples, got '
                         f'{len(triples)}')
    ts = [t for tr in triples for t in tr[:3] if t is not None]
    _build.device_type(*ts)
    code = _build.dtype_code(*ts)
    rows, ys = [], []
    for x2d, w, bias, scale in triples:
        m, kdim = x2d.shape
        n = w.shape[0]
        if x2d.stride(1) != 1 or w.dim() != 2 or not w.is_contiguous() \
                or w.shape[1] != kdim:
            raise ValueError(f'gemm_grouped needs a row-major x and a '
                             f'contiguous (N, K) weight, got '
                             f'x{tuple(x2d.shape)} {x2d.stride()} '
                             f'w{tuple(w.shape)}')
        if bias is not None and (bias.shape != (n,)
                                 or not bias.is_contiguous()):
            raise ValueError(f'bias must be contiguous ({n},)')
        ys.append(torch.empty((m, n), dtype=x2d.dtype, device=x2d.device))
        rows.append((x2d.data_ptr(), w.data_ptr(),
                     None if bias is None else bias.data_ptr(),
                     ys[-1].data_ptr(), m, n, kdim, x2d.stride(0),
                     ys[-1].stride(0), scale))
    # one C array per argument, an entry per triple
    arrays = [(t * len(rows))(*col)
              for t, col in zip(_GEMM_COLUMNS, zip(*rows))]
    lib = _build.cuda_lib()
    with torch.cuda.device(ys[0].device):
        rc = lib.mos_gemm_grouped(len(rows), *arrays, code,
                                  _build.stream(ys[0]))
    _build.check(rc, 'gemm_grouped')
    return ys


# ----------------------------------------------------------------- wrappers
def attn_fwd(q, k, v, kv_len: Optional[int] = None, *, _route=None):
    """Attention forward over (B, S, H, D) q/k/v -> (B, Sq, H, D).

    K1: CUDA tensors launch csrc/attn_fwd.cu (bf16 on wgmma with an fp32
    softmax, or fp32 throughout) on the design `fwd_route` picks (`_route`
    names one instead, for tests); CPU tensors run `attn_fwd_plain`."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    _build.forward_only('attn_fwd', q, k, v)
    if _build.device_type(q, k, v) == 'cpu':
        return attn_fwd_plain(q, k, v, kv_len)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    route = launch_fwd(q, k, v, out, kv_len=kv_len, route=_route)
    attn_fwd.launches += 1
    count_route(attn_fwd, route)
    return out


attn_fwd.launches = 0
attn_fwd.routes = {}


def attention_packed(x, ctx, wq, wk, wv, wo, bias, heads: int):
    """Whole attention processor around K1: plain q/k/v projections in the
    natural (B, S, H·D) layout, `attn_fwd`, plain out-projection + bias.
    x (B, Sq, C); ctx (B, Sk, Cc); wq (C, C); wk/wv (C, Cc); wo (C, C)."""
    b, sq, c = x.shape
    d = c // heads
    q = F.linear(x, wq).view(b, sq, heads, d)
    k = F.linear(ctx, wk).view(b, -1, heads, d)
    v = F.linear(ctx, wv).view(b, -1, heads, d)
    o = attn_fwd(q, k, v)
    return F.linear(o.reshape(b, sq, c), wo, bias)


def attention_block(x, ctx, wq, wk, wv, wo, bias, heads: int,
                    bias_q=None, bias_k=None, bias_v=None):
    """Whole attention processor, K3: x (B, Sq, C), ctx (B, Sk, Cc) ->
    to_out(softmax(q kᵀ/√D) v) + bias, q/k/v with optional biases.

    CUDA tensors: the q, k and v projections in one grouped GEMM launch
    (csrc/gemm_hopper.cu, 1/√D folded into q), the attention core with
    scale 1 (csrc/attn_wide.cu for bf16 heads wider than 160, else
    csrc/attn_fwd.cu) and the out-projection, all hand-written; CPU tensors
    run `attention_block_plain`."""
    _build.forward_only('attention_block', x, ctx, wq, wk, wv, wo, bias,
                        bias_q, bias_k, bias_v)
    if _build.device_type(x, ctx, wq, wk, wv, wo) == 'cpu':
        return attention_block_plain(x, ctx, wq, wk, wv, wo, bias, heads,
                                     bias_q, bias_k, bias_v)
    b, sq, c = x.shape
    sk = ctx.shape[1]
    if c % heads:
        raise ValueError(f'{heads} heads do not divide width {c}')
    d = c // heads
    if d > WIDE_MAX_HEAD_DIM:
        raise ValueError(f'attention_block takes head dim <= '
                         f'{WIDE_MAX_HEAD_DIM}, got {d}')
    x2, c2 = x.reshape(b * sq, c), ctx.reshape(b * sk, ctx.shape[-1])
    q, k, v = _gemm_grouped([(x2, wq, bias_q, 1.0 / math.sqrt(d)),
                             (c2, wk, bias_k, 1.0), (c2, wv, bias_v, 1.0)])
    q, k, v = (t.view(b, -1, heads, d) for t in (q, k, v))
    o = torch.empty_like(q)
    launch_fwd(q, k, v, o, scale=1.0)
    y, = _gemm_grouped([(o.view(b * sq, c), wo, bias, 1.0)])
    attention_block.launches += 1
    return y.view(b, sq, c)


attention_block.launches = 0
