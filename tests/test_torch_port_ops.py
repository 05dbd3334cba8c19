"""Port parity for the kernel modules (ops/) on the CPU: each wrapper's plain
version against the JAX function it replaces (Pallas in interpret mode, as
tests/test_ops.py runs it), plus the CPU dispatch and the argument checks
that guard the CUDA launches. The kernels themselves run on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.cpp_extension as cpp

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.ops import fused_attention as jfa
from mixofshow_tpu.ops import gn_stats as jgn
from mixofshow_tpu_torch import ops
from mixofshow_tpu_torch.models import layers
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import flash_attention as pfl
from mixofshow_tpu_torch.ops import fused_attention as pfa
from mixofshow_tpu_torch.ops import gn_stats as pgn
from mixofshow_tpu_torch.ops import region_attention as pra
from test_torch_port_cuda import (ATTN_BF16_REL, ATTN_CASES, REGION_BF16_REL,
                                  REGION_CASES, k1_faults, k7_faults,
                                  twin_err)


def _t(a):
    """numpy (in, out) kernel -> torch (out, in) weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


@pytest.mark.parametrize('sq,sk,c,cc,heads', [
    (256, 256, 80, 80, 2),      # self-attention (D=40)
    (256, 77, 80, 64, 2),       # cross-attention, 77 keys
    (100, 77, 96, 64, 4),       # unaligned q length
    (256, 256, 320, 320, 2),    # D=160
])
def test_attention_packed_matches_jax(sq, sk, c, cc, heads):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, sq, c)).astype(np.float32)
    ctx = rng.normal(0, 1, (2, sk, cc)).astype(np.float32)
    wq, wo = (rng.normal(0, 0.08, (c, c)).astype(np.float32) for _ in '12')
    wk, wv = (rng.normal(0, 0.08, (cc, c)).astype(np.float32) for _ in '12')
    bo = rng.normal(0, 0.05, (c,)).astype(np.float32)
    ref = np.asarray(jfa.attention_packed(
        jnp.asarray(x), jnp.asarray(ctx), wq, wk, wv, wo, bo, heads,
        precise=True))
    before = pfa.attn_fwd.launches
    out = pfa.attention_packed(torch.from_numpy(x), torch.from_numpy(ctx),
                               _t(wq), _t(wk), _t(wv), _t(wo),
                               torch.from_numpy(bo), heads)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    assert pfa.attn_fwd.launches == before   # CPU: plain version, no launch


@pytest.mark.parametrize('s,c,heads,qkv_bias', [
    (200, 128, 1, True),        # VAE shape: one head, d == c, all biases
    (100, 96, 4, False),        # UNet-style: no q/k/v bias
])
def test_attention_block_matches_jax(s, c, heads, qkv_bias):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, s, c)).astype(np.float32)
    w = [rng.normal(0, 0.08, (c, c)).astype(np.float32) for _ in range(4)]
    b = [rng.normal(0, 0.05, (c,)).astype(np.float32) for _ in range(4)]
    qkv = b[:3] if qkv_bias else [None] * 3
    ref = np.asarray(jfa.attention_block(
        jnp.asarray(x), jnp.asarray(x), *w, b[3], heads, precise=True,
        bias_q=qkv[0], bias_k=qkv[1], bias_v=qkv[2]))
    tb = [None if v is None else torch.from_numpy(v) for v in qkv]
    xt = torch.from_numpy(x)
    before = pfa.attention_block.launches
    out = pfa.attention_block(xt, xt, *map(_t, w), torch.from_numpy(b[3]),
                              heads, *tb)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=1e-4)
    assert pfa.attention_block.launches == before


@pytest.mark.parametrize('shape', [(2, 24, 16, 128), (3, 7, 5, 24)])
def test_spatial_sums_matches_jax(shape):
    x = np.random.default_rng(7).normal(0, 1, shape).astype(np.float32)
    js, js2 = jgn.spatial_sums(jnp.asarray(x))                 # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)              # NCHW view
    for t in (xt.contiguous(), xt):                           # both layouts
        ps, ps2 = pgn.spatial_sums(t)
        assert ps.dtype == ps2.dtype == torch.float32
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(ps2.numpy(), np.asarray(js2), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize('act', ['none', 'silu'])
def test_scale_bias_act_matches_jax(act):
    """K8's twin and its backward against JAX `scale_bias_act` (Pallas in
    interpret mode) and `jax.grad` of it, NHWC there, NCHW here: forward
    1e-5, gradients 1e-4 (tests/test_ops.py's bounds)."""
    rng = np.random.default_rng(13)
    x = rng.normal(0, 1, (2, 16, 8, 128)).astype(np.float32)
    a = rng.normal(1, 0.2, (2, 128)).astype(np.float32)
    b = rng.normal(0, 0.2, (2, 128)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)

    def jloss(*t):
        return (jgn.scale_bias_act(*t, act) * w).sum()

    want = np.asarray(jgn.scale_bias_act(jnp.asarray(x), a, b, act))
    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), a, b)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    at, bt = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    before = pgn.scale_bias_act.launches
    out = pgn.scale_bias_act(xt, at, bt, act)
    (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    assert pgn.scale_bias_act.launches == before
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    for got, ref in ((xt.grad.permute(0, 2, 3, 1), wgrads[0]),
                     (at.grad, wgrads[1]), (bt.grad, wgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_group_norm_kernel_route_matches_plain_route():
    """The VAE's route (K2 sums, K8 apply) and the UNet's plain route give
    one GroupNorm on the CPU: fp32, the same sums in another order."""
    x = torch.randn(2, 16, 6, 5, generator=torch.Generator().manual_seed(2))
    norm = torch.nn.GroupNorm(4, 16)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    for act in (None, 'silu'):
        torch.testing.assert_close(
            layers.group_norm(x, norm, act, stats='kernel'),
            layers.group_norm(x, norm, act), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match='act must be one of'):
        pgn.scale_bias_act(x, torch.ones(2, 16), torch.zeros(2, 16), 'gelu')
    with pytest.raises(TypeError, match='fp32'):
        pgn.scale_bias_act(x, torch.ones(2, 16).double(), torch.zeros(2, 16))


def test_attn_fwd_plain_masks_keys_past_kv_len():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 33, 3, 24, generator=g) for _ in range(3))
    out = pfa.attn_fwd(q, k, v, kv_len=20)
    want = pfa.attn_fwd(q, k[:, :20], v[:, :20])
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('d', [40, 80])
def test_attn_fwd_plain_bf16_matches_packed_flash(d):
    """bf16 q/k/v: K1's twin rounds q·scale to bf16 before the logits, as
    `_packed_fwd_kernel` does, and stays under one bf16 ulp of the top
    binade ([0.25, 0.5): 1.95e-3) from `_packed_flash` run in interpret
    mode (bf16 matmul operands, heads zero-padded to 128 lanes). One CPU
    thread: a one-ulp flip must not hang on the order of a parallel sum."""
    b, s, h = 1, 1024, 2
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).bfloat16() for _ in range(3))
    dp = jfa._dp(d)

    def packed(t):   # (B, S, H, D) -> (B, S, H·Dp), heads zero-padded
        a = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.pad(a, ((0, 0), (0, 0), (0, 0), (0, dp - d))).reshape(
            b, s, h * dp)
    want = jfa._packed_flash(packed(q), packed(k), packed(v), h, d, s)
    want = np.asarray(want.astype(jnp.float32)).reshape(b, s, h, dp)[..., :d]
    got = pfa.attn_fwd(q, k, v)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 1.5e-3


@pytest.mark.parametrize('b,sq,sk,h,d,kv_len', ATTN_CASES)
def test_attn_card_bound_separates_rounding_from_faults(b, sq, sk, h, d,
                                                        kv_len):
    """The bound the card tests hold K1 to in bf16, at their shapes: the
    kernel's own rounding (P to bf16 as the A operand of P·V, the row sums
    of the fp32 P) stays within it of the twin; every planted fault is over
    it."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .bfloat16() for s in ((b, sq, h, d), (b, sk, h, d),
                                     (b, sk, h, d)))
    ref = pfa.attn_fwd_plain(q, k, v, kv_len)
    logits = torch.einsum('bqhd,bkhd->bhqk', pfa.scaled_q(q), k.float())
    logits[..., kv_len:] = pfa.NEG_INF
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    other = torch.einsum('bhqk,bkhd->bqhd', p.bfloat16().float(), v.float()) \
        / p.sum(-1).transpose(1, 2)[..., None]
    assert twin_err(other.bfloat16(), ref) <= ATTN_BF16_REL
    for bad in k1_faults(q, k, v, kv_len):
        assert twin_err(bad, ref) > ATTN_BF16_REL


@pytest.mark.parametrize('b,h,w,heads,d,sk,boxes', REGION_CASES)
def test_region_card_bound_separates_rounding_from_faults(b, h, w, heads, d,
                                                          sk, boxes):
    """The bound the card tests and chip_smoke.py hold K7 to in bf16, at
    their shapes: the kernel's own rounding (P to bf16 as the A operand of
    P·V, normalised by the row sums of the fp32 P, the blend in fp32)
    stays within it of the twin; every planted fault is over it."""
    rng = np.random.default_rng(7)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .bfloat16()
    q = randn(b, h * w, heads, d)
    gk, gv = randn(b, sk, heads, d), randn(b, sk, heads, d)
    rk, rv = (randn(len(boxes), b, sk, heads, d) for _ in range(2))
    px = pra.boxes_to_grid(boxes, h, w)
    ref = pra.region_attention_plain(q, gk, gv, rk, rv, px, (h, w))

    def attend(q, k, v):
        s = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(q.shape[-1])
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return torch.einsum('bhqk,bkhd->bqhd', p.bfloat16().float(), v) \
            / p.sum(-1).transpose(1, 2)[..., None]
    other = pra.region_blend(attend, *(t.float() for t in (q, gk, gv, rk, rv)),
                             px, (h, w)).bfloat16()
    assert twin_err(other, ref) <= REGION_BF16_REL
    faults = k7_faults(q, gk, gv, rk, rv, px, (h, w))
    assert faults
    for bad in faults:
        assert twin_err(bad, ref) > REGION_BF16_REL


def _zeros(*shape, **kw):
    return torch.zeros(*shape, **kw)


_Q = _zeros(1, 8, 2, 16)
_T = _zeros(1, 8, 16, 2).transpose(2, 3)
_M = _zeros(1, 2, 4, 6, device='meta')
_W = _zeros(8, 8)
LAUNCH_CHECKS = {
    'head dim': (lambda: pfl.launch_fwd(*[_zeros(1, 8, 1, 520)] * 4,
                                        kv_len=8), ValueError, 'head dim'),
    'kv_len': (lambda: pfl.launch_fwd(_Q, _Q, _Q, _Q, kv_len=0), ValueError,
               'kv_len'),
    'strides': (lambda: pfl.launch_fwd(_T, _T, _T, _T, kv_len=8), ValueError,
                'contiguous'),
    'dtype': (lambda: pfl.launch_fwd(*[_Q.half()] * 4, kv_len=8), TypeError,
              None),
    'K4 head dim': (lambda: pfl.launch_fwd(*[_zeros(1, 8, 1, 168)] * 4,
                                           _zeros(1, 1, 8)), ValueError,
                    'head dim <= 160'),
    'one device': (lambda: pfa.attn_fwd(_Q, _Q.to('meta'), _Q), ValueError,
                   'one device'),
    'sums device': (lambda: pgn.spatial_sums(_M), ValueError,
                    'unsupported device'),
    'apply device': (lambda: pgn.scale_bias_act(
        _M, _zeros(1, 2, device='meta'), _zeros(1, 2, device='meta')),
        ValueError, 'unsupported device'),
    'gemm weight width': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8), _zeros(3, 7), None, 1.0)]), ValueError, 'weight'),
    'gemm strided x': (lambda: pfa._gemm_grouped(
        [(_zeros(8, 4).t(), _zeros(3, 8), None, 1.0)]), ValueError,
        'row-major'),
    'gemm strided weight': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8), _zeros(8, 3).t(), None, 1.0)]), ValueError,
        'weight'),
    'gemm bias shape': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8), _W, _zeros(7), 1.0)]), ValueError, 'bias'),
    'gemm no triple': (lambda: pfa._gemm_grouped([]), ValueError,
                       '1 to 3'),
    'gemm four triples': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8), _W, None, 1.0)] * 4), ValueError, '1 to 3'),
    'gemm mixed dtypes': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8), _W, None, 1.0),
         (_zeros(4, 8).bfloat16(), _W.bfloat16(), None, 1.0)]), TypeError,
        'one dtype'),
    'gemm half': (lambda: pfa._gemm_grouped(
        [(_zeros(4, 8).half(), _W.half(), None, 1.0)]), TypeError, None),
}


@pytest.mark.parametrize('case', sorted(LAUNCH_CHECKS))
def test_cuda_launch_checks_raise_before_launch(case):
    """Shapes and types the kernels cannot take raise (ValueError or
    TypeError) in the wrappers' checks, before anything is built or
    launched: never a silent fallback to the plain version."""
    fn, exc, match = LAUNCH_CHECKS[case]
    with pytest.raises(exc, match=match):
        fn()


def test_launch_registry():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {'attn_fwd': 0, 'gn_spatial_sums': 0,
                                   'attn_block': 0, 'region_attn': 0,
                                   'flash_fwd': 0, 'flash_bwd_dkv': 0,
                                   'flash_bwd_dq': 0, 'gn_apply': 0}
    pgn.spatial_sums(torch.ones(1, 4, 2, 2))
    pgn.scale_bias_act(torch.ones(1, 4, 2, 2), torch.ones(1, 4),
                       torch.zeros(1, 4), 'silu')
    assert ops.launch_counts()['gn_spatial_sums'] == 0
    assert ops.launch_counts()['gn_apply'] == 0


def test_build_needs_nvcc_and_keys_the_library_on_its_sources(monkeypatch):
    """No nvcc: building raises (nothing falls back to the plain versions);
    the library's name is a hash of the csrc sources and flags."""
    monkeypatch.setattr(cpp, 'CUDA_HOME', None)
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == '.so'
    assert path == _build.library_path()
    monkeypatch.setattr(_build, 'NVCC_FLAGS', _build.NVCC_FLAGS + ('-G',))
    assert _build.library_path() != path
    srcs = {p.name for p in _build.CSRC_DIR.iterdir()}
    assert {'attn_fwd.cu', 'attn_wide.cu', 'gemm_hopper.cu', 'mma.cuh',
            'wgmma.cuh', 'region_attn.cu', 'flash_bwd_dkv.cu',
            'flash_bwd_dq.cu'} <= srcs
