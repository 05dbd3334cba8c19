"""Port parity for the kernel modules (ops/) on the CPU: each wrapper's plain
version against the JAX function it replaces (Pallas in interpret mode, as
tests/test_ops.py runs it), plus the CPU dispatch and the argument checks
that guard the CUDA launches. The kernels themselves run on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.cpp_extension as cpp

from mixofshow_tpu.ops import fused_attention as jfa
from mixofshow_tpu.ops import gn_stats as jgn
from mixofshow_tpu_torch import ops
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import fused_attention as pfa
from mixofshow_tpu_torch.ops import gn_stats as pgn


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


def test_attn_fwd_plain_masks_keys_past_kv_len():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 33, 3, 24, generator=g) for _ in range(3))
    out = pfa.attn_fwd(q, k, v, kv_len=20)
    want = pfa.attn_fwd(q, k[:, :20], v[:, :20])
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


def test_cuda_launch_checks_raise_before_launch():
    """Shapes the kernels cannot take raise (ValueError/TypeError) in the
    wrapper's checks — never a silent fallback to the plain version."""
    q = torch.zeros(1, 8, 1, 520)
    with pytest.raises(ValueError, match='head dim'):
        pfa._launch_attn(q, q, q, q, 8)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match='kv_len'):
        pfa._launch_attn(q, q, q, q, 0)
    with pytest.raises(ValueError, match='contiguous'):
        t = torch.zeros(1, 8, 16, 2).transpose(2, 3)
        pfa._launch_attn(t, t, t, t, 8)
    with pytest.raises(TypeError):
        h = q.half()
        pfa._launch_attn(h, h, h, h, 8)
    with pytest.raises(ValueError):
        pfa._gemm_bias(torch.zeros(4, 8), torch.zeros(3, 7), None)
    with pytest.raises(ValueError, match='one device'):
        pfa.attn_fwd(q, q.to('meta'), q)
    with pytest.raises(ValueError, match='unsupported device'):
        pgn.spatial_sums(torch.zeros(1, 2, 4, 6, device='meta'))


def test_launch_registry():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {'attn_fwd': 0, 'gn_spatial_sums': 0,
                                   'attn_block': 0, 'region_attn': 0}
    pgn.spatial_sums(torch.ones(1, 4, 2, 2))
    assert ops.launch_counts()['gn_spatial_sums'] == 0


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
    assert {'attn_fwd.cu', 'gemm_bias.cu', 'mma.cuh', 'region_attn.cu'} <= srcs
