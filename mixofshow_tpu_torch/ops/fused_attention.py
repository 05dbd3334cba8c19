"""Attention kernels of the sampling path and their plain twins.

Port of mixofshow_tpu/ops/fused_attention.py:

  * `attn_fwd` (K1, csrc/attn_fwd.cu) replaces `_packed_fwd_kernel`: the
    attention forward of UNet self-attention with >= 1024 keys. The TPU
    version ran on q/k/v whose heads were zero-padded to 128 lanes in HBM;
    the port's projections produce the natural (B, S, H, D) layout and the
    kernel pads D only inside its shared-memory tiles.
    `attention_packed` is the processor around it: the q/k/v/out projections
    stay plain `F.linear` products, as the JAX package left them to XLA.
  * `attention_block` (K3, csrc/gemm_bias.cu + the attn_fwd core) replaces
    `_kernel`, the whole attention processor of the VAE mid-block: q/k/v
    projections with biases, softmax per head, out-projection plus bias.

Weights use the PyTorch layout, (out, in). Each wrapper runs its plain
version for CPU tensors and launches its kernel for CUDA tensors; there is
no fallback between the two. `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mixofshow_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 512


# ----------------------------------------------------------- plain versions
def attn_fwd_plain(q, k, v, kv_len: Optional[int] = None):
    """softmax(q kᵀ / √D) v over (B, S, H, D) in fp32, keys >= kv_len
    masked; returned in q's dtype."""
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
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
def _launch_attn(q, k, v, out, kv_len: int) -> None:
    """Launch csrc/attn_fwd.cu on (B, S, H, D) views whose heads are
    contiguous within a token (head stride D, element stride 1)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) \
            or out.shape != q.shape:
        raise ValueError(f'shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}'
                         f' v{tuple(v.shape)} out{tuple(out.shape)}')
    if d > MAX_HEAD_DIM:
        raise ValueError(f'attn_fwd takes head dim <= {MAX_HEAD_DIM}, got {d}')
    if not 1 <= kv_len <= sk:
        raise ValueError(f'kv_len {kv_len} outside [1, {sk}]')
    for t in (q, k, v, out):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError('attn_fwd needs heads contiguous within a token '
                             f'(strides {t.stride()})')
    code = _build.dtype_code(q, k, v, out)
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, d, kv_len,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / math.sqrt(d), code, _build.stream(q))
    _build.check(rc, 'attn_fwd')


def _gemm_bias(x2d, w, bias):
    """Launch csrc/gemm_bias.cu: (M, K) · (N, K)ᵀ + bias -> (M, N)."""
    m, kdim = x2d.shape
    n = w.shape[0]
    if x2d.stride(1) != 1 or not w.is_contiguous() or w.shape[1] != kdim:
        raise ValueError(f'gemm_bias needs a row-major x and a contiguous '
                         f'(N, K) weight, got x{tuple(x2d.shape)} '
                         f'{x2d.stride()} w{tuple(w.shape)}')
    if bias is not None and (bias.shape != (n,) or not bias.is_contiguous()):
        raise ValueError(f'bias must be contiguous ({n},)')
    code = _build.dtype_code(x2d, w, *(() if bias is None else (bias,)))
    y = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    lib = _build.cuda_lib()
    with torch.cuda.device(x2d.device):
        rc = lib.mos_gemm_bias(
            x2d.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            m, n, kdim, x2d.stride(0), y.stride(0), code, _build.stream(x2d))
    _build.check(rc, 'gemm_bias')
    return y


# ----------------------------------------------------------------- wrappers
def attn_fwd(q, k, v, kv_len: Optional[int] = None):
    """Attention forward over (B, S, H, D) q/k/v -> (B, Sq, H, D).

    K1: CUDA tensors launch csrc/attn_fwd.cu (bf16 on tensor cores with an
    fp32 softmax, or fp32 throughout); CPU tensors run `attn_fwd_plain`."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    if _build.device_type(q, k, v) == 'cpu':
        return attn_fwd_plain(q, k, v, kv_len)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_attn(q, k, v, out, kv_len)
    attn_fwd.launches += 1
    return out


attn_fwd.launches = 0


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

    CUDA tensors: the q, k and v projections (csrc/gemm_bias.cu), the
    attention core (csrc/attn_fwd.cu) and the out-projection, all
    hand-written; CPU tensors run `attention_block_plain`."""
    if _build.device_type(x, ctx, wq, wk, wv, wo) == 'cpu':
        return attention_block_plain(x, ctx, wq, wk, wv, wo, bias, heads,
                                     bias_q, bias_k, bias_v)
    b, sq, c = x.shape
    sk = ctx.shape[1]
    if c % heads:
        raise ValueError(f'{heads} heads do not divide width {c}')
    d = c // heads
    x2, c2 = x.reshape(b * sq, c), ctx.reshape(b * sk, ctx.shape[-1])
    q = _gemm_bias(x2, wq, bias_q).view(b, sq, heads, d)
    k = _gemm_bias(c2, wk, bias_k).view(b, sk, heads, d)
    v = _gemm_bias(c2, wv, bias_v).view(b, sk, heads, d)
    o = torch.empty_like(q)
    _launch_attn(q, k, v, o, sk)
    y = _gemm_bias(o.view(b * sq, c), wo, bias)
    attention_block.launches += 1
    return y.view(b, sq, c)


attention_block.launches = 0
