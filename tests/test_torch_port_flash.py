"""The port's flash attention (K4-K6 twins and the autograd Function) and the
forward-only guard, on the CPU.

The plain twins are held against the JAX package's Pallas kernels run in
interpret mode, as the JAX suite runs them on the CPU (atol 2e-2: the Pallas
kernels round their matmul operands to bf16 even for fp32 inputs), and
against JAX's dense fp32 `sdpa` and its `jax.vjp` (atol 1e-5). The kernels
themselves run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixofshow_tpu.models import layers as jlayers
from mixofshow_tpu.ops import flash_attention as jflash
from mixofshow_tpu_torch import ops
from mixofshow_tpu_torch.models import layers
from mixofshow_tpu_torch.ops import flash_attention as fl
from mixofshow_tpu_torch.ops import fused_attention as fa
from mixofshow_tpu_torch.ops import gn_stats as gs
from mixofshow_tpu_torch.ops import region_attention as ra
from test_torch_port_cuda import FLASH_CASES, flash_bound, flash_err

SHAPES = [(1, 256, 1024, 2, 16),     # the tiny UNet's res-64 layer, cut
          (2, 130, 1100, 2, 40),     # ragged Sq and Sk
          (1, 128, 1024, 1, 80)]


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))]


def _port(q, k, v, do, dtype=torch.float32):
    """Output and (dq, dk, dv) through the autograd Function."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = fl.flash_attention(*ts)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize('b,sq,sk,h,d', SHAPES)
def test_flash_matches_pallas_interpret(b, sq, sk, h, d):
    q, k, v, do = _inputs(b, sq, sk, h, d)
    jo, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a),
                      *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    _, jlse, _ = jflash._fwd_call(*map(jnp.asarray, (q, k, v)), 256, 512)
    out, grads = _port(q, k, v, do)
    np.testing.assert_allclose(out, np.asarray(jo), atol=2e-2, rtol=0)
    _, lse = fl.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :sq, 0],
                               atol=2e-2, rtol=0)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize('b,sq,sk,h,d', SHAPES)
def test_flash_matches_dense_fp32(b, sq, sk, h, d):
    q, k, v, do = _inputs(b, sq, sk, h, d, seed=1)
    jo, vjp = jax.vjp(lambda *a: jlayers.sdpa(*a)[0],
                      *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    out, grads = _port(q, k, v, do)
    np.testing.assert_allclose(out, np.asarray(jo), atol=1e-5, rtol=0)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_flash_bf16_matches_pallas_interpret():
    """bf16 inputs: the twins round q·scale, P and dS to bf16 where the
    Pallas kernels do."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs(2, 130, 1100, 2, 40, seed=2))
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v, do)]
    jo, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a), *jb[:3])
    jgrads = vjp(jb[3])
    out, grads = _port(*(t.float().numpy() for t in (q, k, v, do)),
                       dtype=torch.bfloat16)
    np.testing.assert_allclose(out, np.asarray(jo, np.float32), atol=2e-2)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=2e-2)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,h,d', FLASH_CASES)
def test_flash_card_bound_separates_rounding_from_a_fault(dtype, b, sq, sk,
                                                          h, d):
    """The bound the card tests hold K4-K6 to, at their shapes: a backward
    that keeps P and dS in fp32 (another legitimate rounding) stays within
    it in bf16; one that drops Dvec from dS, as a faulty K5 or K6 would, is
    over it in dq and dk."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in
                   _inputs(b, sq, sk, h, d, seed=6))
    o, lse = fl.flash_fwd_plain(q, k, v)
    dvec = fl.flash_dvec(do, o)
    want = fl.flash_bwd_plain(q, k, v, do, lse, dvec)
    bad = fl.flash_bwd_plain(q, k, v, do, lse, torch.zeros_like(dvec))
    bound = flash_bound(dtype)
    assert flash_err(bad[0], want[0]) > bound
    assert flash_err(bad[1], want[1]) > bound
    if dtype == torch.bfloat16:
        qs = fl._scaled_q(q)
        p = torch.exp(torch.einsum('bqhd,bkhd->bhqk', qs, k.float())
                      - lse[..., None])
        ds = p * (torch.einsum('bqhd,bkhd->bhqk', do.float(), v.float())
                  - dvec[..., None])
        other = (torch.einsum('bhqk,bkhd->bqhd', ds, k.float()) / d ** 0.5,
                 torch.einsum('bhqk,bqhd->bkhd', ds, qs),
                 torch.einsum('bhqk,bqhd->bkhd', p, do.float()))
        for got, ref in zip(other, want):
            assert flash_err(got.to(dtype), ref) <= bound / 2


def test_autograd_function_and_wrappers_on_cpu():
    """The Function's backward runs the wrappers, which on CPU tensors run
    the twins (the FA2 formulas with the LSE) and count no launch; a
    strided dO is taken."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 200, 1030, 2, 24,
                                                         seed=3))
    ops.reset_launch_counts()
    o, lse = fl.flash_fwd(q, k, v)
    ro, rlse = fl.flash_fwd_plain(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 2, 200, 24)).astype(np.float32))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    # dO reaches the Function transposed (non-contiguous)
    (fl.flash_attention(*ts).transpose(1, 2) * w).sum().backward()
    do = w.transpose(1, 2)
    assert not do.is_contiguous()
    dvec = fl.flash_dvec(do, o)
    want = fl.flash_bwd_plain(q, k, v, do.contiguous(), lse, dvec)
    for t, g in zip(ts, want):
        torch.testing.assert_close(t.grad, g, atol=1e-6, rtol=1e-6)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, dvec)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
    for a, b_ in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=1e-6)
    counts = ops.launch_counts()
    assert all(counts[n] == 0 for n in ('flash_fwd', 'flash_bwd_dkv',
                                        'flash_bwd_dq'))
    # plain backward == autograd of the plain forward
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (fa.attn_fwd_plain(qa, ka, va).transpose(1, 2) * w).sum().backward()
    for t, ref in zip(ts, (qa, ka, va)):
        torch.testing.assert_close(t.grad, ref.grad, atol=1e-5, rtol=1e-5)


def test_flash_attention_supported_is_the_jax_rule_plus_d160():
    for sq in (64, 127, 128, 4096):
        for sk in (77, 1023, 1024, 4096, 16384, 40000):
            for d in (16, 40, 80, 160, 161, 512):
                want = jflash.flash_attention_supported(sq, sk, d) and \
                    d <= 160
                assert fl.flash_attention_supported(sq, sk, d) == want, \
                    (sq, sk, d)


def test_sdpa_routes_large_attention_to_flash(monkeypatch):
    """layers.sdpa takes the flash route at >= 1024 keys and 128 queries,
    the dense one below, with return_probs and for causal masks; both
    match JAX's dense sdpa."""
    calls = []
    real = layers.flash_attention
    monkeypatch.setattr(layers, 'flash_attention',
                        lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(5)
    for sk, routed in ((1024, True), (1023, False)):
        q, k, v = (rng.normal(size=s).astype(np.float32) for s in
                   ((1, 128, 2, 16), (1, sk, 2, 16), (1, sk, 2, 16)))
        calls.clear()
        out = layers.sdpa(*map(torch.from_numpy, (q, k, v)))
        assert bool(calls) == routed
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jlayers.sdpa(*map(jnp.asarray,
                                                      (q, k, v)))[0]),
            atol=1e-5)
        calls.clear()
        layers.sdpa(*map(torch.from_numpy, (q, k, v)), return_probs=True)
        assert not calls


def test_forward_only_kernels_refuse_grad():
    """K1, K2, K3 and K7 have no backward: with grad mode on and an input
    that requires grad they raise (on the CPU too) instead of returning a
    tensor without a gradient; under no_grad they run."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, grad=False):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    q = t(1, 16, 2, 8, grad=True)
    kv = t(1, 16, 2, 8)
    x = t(1, 16, 8, grad=True)
    w = [t(8, 8) for _ in range(4)]
    calls = {
        'attn_fwd': lambda: fa.attn_fwd(q, kv, kv),
        'attention_block': lambda: fa.attention_block(x, x, *w, None, 1),
        'spatial_sums': lambda: gs.spatial_sums(t(1, 4, 4, 4, grad=True)),
        'region_attention': lambda: ra.region_attention(
            t(1, 16, 2, 8, grad=True), t(1, 77, 2, 8), t(1, 77, 2, 8),
            t(1, 1, 77, 2, 8), t(1, 1, 77, 2, 8), [[0, 0, 2, 2]], (4, 4)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f'{name} is forward-only'):
            call()
        with torch.no_grad():
            call()
        with torch.inference_mode():
            call()
