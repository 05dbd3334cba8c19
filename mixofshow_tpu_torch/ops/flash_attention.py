"""Differentiable flash attention of the training path and its plain twins.

Port of mixofshow_tpu/ops/flash_attention.py, the `jax.custom_vjp`
`flash_attention` over three TPU kernels:

  * `flash_fwd` (K4, `mos_flash_fwd` in csrc/attn_fwd.cu) replaces
    `_fwd_kernel`: attention forward with an online softmax that also
    stores the per-row log-sum-exp, (B, H, Sq) fp32;
  * `flash_bwd_dkv` (K5, csrc/flash_bwd_dkv.cu) replaces `_bwd_dkv_kernel`:
    dK and dV, one block per 64 keys streaming the query tiles;
  * `flash_bwd_dq` (K6, csrc/flash_bwd_dq.cu) replaces `_bwd_dq_kernel`:
    dQ, one block per 64 queries streaming the key tiles.

All three fold the softmax scale into q before the bf16 rounding, as the TPU
kernels did, and the plain twins round in the same order. P is recomputed
from the LSE in the backward; `Dvec = rowsum(dO ∘ O)` stays plain torch
(`flash_dvec`), as the JAX package kept it outside Pallas. The backward has
no atomics, so two backward passes give bit-identical gradients.

`flash_attention(q, k, v)` is a `torch.autograd.Function` over (B, S, H, D):
the forward calls `flash_fwd` and the backward `flash_bwd_dkv` and
`flash_bwd_dq`, the wrappers that dispatch on the device: CPU tensors run
the plain twins (the backward ones from the FA2 formulas with the LSE, not
autograd of the plain forward), CUDA tensors launch K4, then K5 and K6.
There is no fallback between the two. `<wrapper>.launches` counts kernel
launches.
"""
from __future__ import annotations

import math

import torch

from mixofshow_tpu_torch.ops import _build

MAX_HEAD_DIM = 160  # SD1.x's widest head


def flash_attention_supported(sq: int, sk: int, d: int) -> bool:
    """Shapes `layers.sdpa` routes here: the JAX package's rule
    (sk >= 1024, sq >= 128, and its VMEM cap on resident K/V, kept only so
    that the same layers take the kernel) plus D <= 160."""
    return (d <= MAX_HEAD_DIM and sq >= 128 and sk >= 1024
            and sk * d * 2 * 2 * 2 <= 12 * 1024 * 1024)


# ----------------------------------------------------------- plain versions
def _scaled_q(q):
    """q · 1/√D in fp32, rounded to q's dtype, back in fp32."""
    return (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype).float()


def flash_fwd_plain(q, k, v):
    """(o in q's dtype, lse (B, H, Sq) fp32) of softmax(q̃ kᵀ) v, q̃ the
    scaled and rounded q; P rounds to v's dtype for the value product, as
    the kernel's does."""
    s = torch.einsum('bqhd,bkhd->bhqk', _scaled_q(q), k.float())
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return o.to(q.dtype), lse


def flash_dvec(do, o):
    """Dvec = rowsum(dO ∘ O) in fp32, (B, H, Sq) contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_p_ds(q, k, v, do, lse, dvec):
    """(q̃, P, dS) in fp32 from the FA2 formulas: P from the LSE, dS = P ∘
    (dO Vᵀ − Dvec); P and dS rounded to the inputs' dtype as the kernels'
    operands. Both backward kernels recompute them, and so do their twins."""
    qs = _scaled_q(q)
    s = torch.einsum('bqhd,bkhd->bhqk', qs, k.float())
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum('bqhd,bkhd->bhqk', do.float(), v.float())
    ds = p * (dp - dvec[..., None])
    return qs, p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dkv_plain(q, k, v, do, lse, dvec):
    """(dk, dv) in the inputs' dtype: dV = Pᵀ dO, dK = dSᵀ q̃."""
    qs, p, ds = _bwd_p_ds(q, k, v, do, lse, dvec)
    dv = torch.einsum('bhqk,bqhd->bkhd', p, do.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qs)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, dvec):
    """dq in the inputs' dtype: dQ = dS K · scale."""
    _, _, ds = _bwd_p_ds(q, k, v, do, lse, dvec)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_plain(q, k, v, do, lse, dvec):
    """(dq, dk, dv): the whole plain backward, both twins together."""
    return (flash_bwd_dq_plain(q, k, v, do, lse, dvec),
            *flash_bwd_dkv_plain(q, k, v, do, lse, dvec))


# ----------------------------------------------------------------- wrappers
def _check(q, k, v, *rest, contiguous: bool):
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) \
            or any(t.shape != q.shape for t in rest):
        raise ValueError(f'shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}'
                         f' v{tuple(v.shape)} '
                         f'{[tuple(t.shape) for t in rest]}')
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f'flash attention takes head dim <= {MAX_HEAD_DIM},'
                         f' got {d}')
    for t in (q, k, v, *rest):
        if contiguous and not t.is_contiguous():
            raise ValueError('flash backward needs contiguous (B, S, H, D) '
                             f'tensors (strides {t.stride()})')
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError('flash attention needs heads contiguous within '
                             f'a token (strides {t.stride()})')
    return _build.dtype_code(q, k, v, *rest)


def _check_stats(lse, dvec, b, h, sq):
    for t in (lse, dvec):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous():
            raise ValueError(f'lse and dvec must be contiguous fp32 '
                             f'({b}, {h}, {sq}), got {t.dtype} '
                             f'{tuple(t.shape)}')


def flash_fwd(q, k, v):
    """Attention forward over (B, S, H, D) -> (o (B, Sq, H, D), lse (B, H,
    Sq) fp32). K4: CUDA tensors (fp32 or bf16, heads contiguous within a
    token) launch mos_flash_fwd; CPU tensors run `flash_fwd_plain`."""
    if _build.device_type(q, k, v) == 'cpu':
        return flash_fwd_plain(q, k, v)
    code = _check(q, k, v, contiguous=False)
    b, sq, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, k.shape[1], h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / math.sqrt(d), code, _build.stream(q))
    _build.check(rc, 'flash_fwd')
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, dvec):
    """(dk, dv) of flash attention. K5: contiguous CUDA tensors launch
    csrc/flash_bwd_dkv.cu; CPU tensors run `flash_bwd_dkv_plain`."""
    if _build.device_type(q, k, v, do, lse, dvec) == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, do, lse, dvec)
    code = _check(q, k, v, do, contiguous=True)
    b, sq, h, d = q.shape
    _check_stats(lse, dvec, b, h, sq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], h, d, 1.0 / math.sqrt(d), code,
            _build.stream(q))
    _build.check(rc, 'flash_bwd_dkv')
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, dvec):
    """dq of flash attention. K6: contiguous CUDA tensors launch
    csrc/flash_bwd_dq.cu; CPU tensors run `flash_bwd_dq_plain`."""
    if _build.device_type(q, k, v, do, lse, dvec) == 'cpu':
        return flash_bwd_dq_plain(q, k, v, do, lse, dvec)
    code = _check(q, k, v, do, contiguous=True)
    b, sq, h, d = q.shape
    _check_stats(lse, dvec, b, h, sq)
    dq = torch.empty_like(q)
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            b, sq, k.shape[1], h, d, 1.0 / math.sqrt(d), code,
            _build.stream(q))
    _build.check(rc, 'flash_bwd_dq')
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand in a strided dO; the kernels read contiguous
        do = do.contiguous()
        dvec = flash_dvec(do, o)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec)
        return flash_bwd_dq(q, k, v, do, lse, dvec), dk, dv


def flash_attention(q, k, v):
    """softmax(q kᵀ / √D) v over (B, S, H, D) q/k/v -> (B, Sq, H, D),
    differentiable in q, k and v (see the module docstring)."""
    return _FlashAttention.apply(q, k, v)
