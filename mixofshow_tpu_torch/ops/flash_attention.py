"""Differentiable flash attention of the training path and its plain twins.

Port of mixofshow_tpu/ops/flash_attention.py, the `jax.custom_vjp`
`flash_attention` over three TPU kernels:

  * `flash_fwd` (K4, csrc/attn_fwd.cu, the wgmma kernel it shares with
    K1) replaces `_fwd_kernel`: attention forward with an online softmax
    that also stores the per-row log-sum-exp, (B, H, Sq) fp32;
  * `flash_bwd_dkv` (K5, csrc/flash_bwd_dkv.cu) replaces `_bwd_dkv_kernel`:
    dK and dV, one block per 128 keys streaming the query tiles;
  * `flash_bwd_dq` (K6, csrc/flash_bwd_dq.cu) replaces `_bwd_dq_kernel`:
    dQ, one block per 128 queries (two warpgroups) streaming the key
    tiles.

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

csrc/attn_fwd.cu has two bf16 designs: the warp-specialised ping-pong
kernel (a TMA producer warp, consumer warpgroups taking turns at the tensor
cores) for heads up to 80 wide, and the lock-step one for wider heads and
for inputs TMA cannot read. `fwd_route`, a pure function of what the inputs
show, picks the design of every K1 and K4 launch. `launch_fwd` is the one
launcher of that kernel, for K1, K3's core and K4: it checks the arguments,
takes the design and passes it to the entry point, which refuses (returns
-1 for) a design the arguments do not allow. `flash_fwd.routes` (and
`attn_fwd.routes`) count launches by design.
"""
from __future__ import annotations

import math

import torch

from mixofshow_tpu_torch.ops import _build

MAX_HEAD_DIM = 160  # SD1.x's widest head
WIDE_MAX_HEAD_DIM = 512  # without an LSE: csrc/attn_wide.cu past 160

# the designs of csrc/attn_fwd.cu's forward, in the order of its Route codes:
# the fp32 SIMT kernel, the bf16 lock-step and ping-pong wgmma kernels, and
# (K1 only, D > 160) csrc/attn_wide.cu's core
ROUTES = ('fp32', 'lockstep', 'pingpong', 'wide')
PINGPONG_MAX_D = 80


def fwd_route(dtype, d: int, aligned: bool) -> str:
    """The design a forward launch of csrc/attn_fwd.cu takes (a name of
    ROUTES), from what its inputs show: bf16 heads up to 80 wide that TMA
    can read (`aligned`, see `tma_aligned`) take the ping-pong design, other
    bf16 heads up to 160 the lock-step one. Measured on an H100 at every K1
    and K4 shape of the main paths, from grids of 96 and 128 blocks on 132
    SMs to 32,768 keys, the ping-pong design was the faster, so the grid and
    the key count do not enter."""
    if dtype == torch.float32:
        return 'fp32'
    if d > MAX_HEAD_DIM:
        return 'wide'
    if d <= PINGPONG_MAX_D and aligned:
        return 'pingpong'
    return 'lockstep'


def tma_aligned(*ts) -> bool:
    """True where every (B, S, H, D) tensor can be read through TMA: a 16 B
    aligned base, and head, token and batch strides of 16 B multiples (a
    single batch's stride is never stepped)."""
    return all(t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0
               and t.stride(1) % 8 == 0
               and (t.shape[0] == 1 or t.stride(0) % 8 == 0) for t in ts)


def launch_route(q, k, v, route=None) -> str:
    """`route` checked against ROUTES, or `fwd_route` of one launch's
    inputs. An explicit route is for tests and the kernel tools that hold
    the designs against each other; the entry point refuses one the
    arguments do not allow."""
    if route is not None:
        if route not in ROUTES:
            raise ValueError(f'route {route!r} is none of {ROUTES}')
        return route
    return fwd_route(q.dtype, q.shape[3], tma_aligned(q, k, v))


def count_route(wrapper, route: str) -> None:
    """One launch of `wrapper` on `route` in its `routes` counter."""
    wrapper.routes[route] = wrapper.routes.get(route, 0) + 1


def _check_shapes(what: str, limit: int, q, k, v, *rest) -> None:
    """(B, S, H, D) q, k and v of one batch, head count and head width up
    to `limit`, and `rest` shaped as q."""
    shape, ks = q.shape, k.shape
    b, sq, h, d = shape
    if ks != v.shape or ks[0] != b or ks[2:] != (h, d) \
            or any(t.shape != shape for t in rest):
        raise ValueError(f'shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}'
                         f' v{tuple(v.shape)} '
                         f'{[tuple(t.shape) for t in rest]}')
    if not 1 <= d <= limit:
        raise ValueError(f'{what} takes head dim <= {limit}, got {d}')


def _check_stats(b: int, h: int, sq: int, **stats) -> None:
    for name, t in stats.items():
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous fp32 '
                             f'({b}, {h}, {sq}), got {t.dtype} '
                             f'{tuple(t.shape)}')


def launch_fwd(q, k, v, out, lse=None, kv_len=None, scale=None,
               route=None) -> str:
    """Launch csrc/attn_fwd.cu's forward into `out`, every argument checked
    first, on (B, S, H, D) views whose heads are contiguous within a token
    (head stride D, element stride 1). Without `lse` (K1, K3's core) heads
    up to 512 wide and the keys >= kv_len masked; with it (K4) heads up to
    160 wide, every key read, and the per-row log-sum-exp stored to `lse`,
    contiguous (B, H, Sq) fp32. The logits are scaled by `scale` (default
    1/√D). Returns the design launched: `route` (see `launch_route`), or
    `fwd_route`'s choice."""
    what, limit = (('attn_fwd', WIDE_MAX_HEAD_DIM) if lse is None
                   else ('flash_fwd', MAX_HEAD_DIM))
    _check_shapes(what, limit, q, k, v, out)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    lo = 1 if lse is None else max(sk, 1)   # K4 reads every key
    if not lo <= kv_len <= sk:
        raise ValueError(f'kv_len {kv_len} outside [{lo}, {sk}]')
    strides = [t.stride() for t in (q, k, v, out)]
    for st in strides:
        if st[3] != 1 or st[2] != d:
            raise ValueError(f'{what} needs heads contiguous within a token '
                             f'(strides {st})')
    if lse is not None:
        _check_stats(b, h, sq, lse=lse)
    code = _build.dtype_code(q, k, v, out)
    route = launch_route(q, k, v, route)
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, h, d, kv_len,
            *[st[i] for st in strides for i in (0, 1)],
            1.0 / math.sqrt(d) if scale is None else scale, code,
            ROUTES.index(route), _build.stream(q))
    _build.check(rc, f'{what} ({route})')
    return route


def flash_attention_supported(sq: int, sk: int, d: int) -> bool:
    """Shapes `layers.sdpa` routes here: the JAX package's rule
    (sk >= 1024, sq >= 128, and its VMEM cap on resident K/V, kept only so
    that the same layers take the kernel) plus D <= 160."""
    return (d <= MAX_HEAD_DIM and sq >= 128 and sk >= 1024
            and sk * d * 2 * 2 * 2 <= 12 * 1024 * 1024)


# ----------------------------------------------------------- plain versions
def scaled_q(q):
    """q · 1/√D in fp32, rounded to q's dtype, back in fp32."""
    return (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype).float()


def flash_fwd_plain(q, k, v):
    """(o in q's dtype, lse (B, H, Sq) fp32) of softmax(q̃ kᵀ) v, q̃ the
    scaled and rounded q; P rounds to v's dtype for the value product, as
    the kernel's does."""
    s = torch.einsum('bqhd,bkhd->bhqk', scaled_q(q), k.float())
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
    qs = scaled_q(q)
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
def _check_bwd(q, k, v, do, lse, dvec):
    """The backward kernels' arguments: contiguous (B, S, H, D) tensors and
    contiguous fp32 (B, H, Sq) statistics. Returns their dtype code."""
    _check_shapes('flash attention', MAX_HEAD_DIM, q, k, v, do)
    for t in (q, k, v, do):
        if not t.is_contiguous():
            raise ValueError('flash backward needs contiguous (B, S, H, D) '
                             f'tensors (strides {t.stride()})')
    b, sq, h, _ = q.shape
    _check_stats(b, h, sq, lse=lse, dvec=dvec)
    return _build.dtype_code(q, k, v, do)


def flash_fwd(q, k, v, *, _route=None):
    """Attention forward over (B, S, H, D) -> (o (B, Sq, H, D), lse (B, H,
    Sq) fp32). K4: CUDA tensors (fp32 or bf16, heads contiguous within a
    token) launch csrc/attn_fwd.cu through `launch_fwd` on the design
    `fwd_route` picks (`_route` names one instead, for tests); CPU tensors
    run `flash_fwd_plain`."""
    if _build.device_type(q, k, v) == 'cpu':
        return flash_fwd_plain(q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = launch_fwd(q, k, v, out, lse, route=_route)
    flash_fwd.launches += 1
    count_route(flash_fwd, route)
    return out, lse


flash_fwd.launches = 0
flash_fwd.routes = {}


def flash_bwd_dkv(q, k, v, do, lse, dvec):
    """(dk, dv) of flash attention. K5: contiguous CUDA tensors launch
    csrc/flash_bwd_dkv.cu; CPU tensors run `flash_bwd_dkv_plain`."""
    if _build.device_type(q, k, v, do, lse, dvec) == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, do, lse, dvec)
    code = _check_bwd(q, k, v, do, lse, dvec)
    b, sq, h, d = q.shape
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
    code = _check_bwd(q, k, v, do, lse, dvec)
    b, sq, h, d = q.shape
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
