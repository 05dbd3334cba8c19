"""Port parity for the model modules at the tiny config, fp32 on the CPU:
the JAX package's weights carried across with convert.load_jax_params, the
same numpy inputs through both, tolerance atol 3e-4 / rtol 1e-3 (VAE decode
atol 5e-4), as the JAX suite's own whole-graph parity tests use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import clip as jclip
from mixofshow_tpu.models import layers as jlayers
from mixofshow_tpu.models import lora as jlora
from mixofshow_tpu.models import unet as junet
from mixofshow_tpu.models import vae as jvae
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import (load_jax_params, lora_from_jax,
                                         state_dict_from_jax)
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet,
                                        layers)
from mixofshow_tpu_torch.models.lora import merge_into

TOL = dict(atol=3e-4, rtol=1e-3)


@pytest.fixture(scope='module')
def bundle():
    return jload('random:tiny', seed=0)


def _lora(params, pred, seed):
    """A JAX LoRA tree with non-zero up (so the delta matters)."""
    tree = jlora.init_lora_tree(seed, params, pred, rank=4)
    return jax.tree.map(lambda a: np.asarray(a) + 0.03, tree)


def test_clip_encode_matches_jax(bundle):
    ucfg, ccfg, _ = zoo.tiny_configs()
    te = load_jax_params(CLIPTextModel(ccfg, 'cpu'), bundle.text_encoder)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, ccfg.vocab_size + 4, (3, 77)).astype(np.int32)
    concept = rng.normal(0, 0.02, (4, ccfg.width)).astype(np.float32)
    lora = _lora(bundle.text_encoder, lambda p: '/attn/' in p, 1)
    ref = jclip.clip_text_encode(bundle.text_encoder, jnp.asarray(ids), ccfg,
                                 concept_embedding=jnp.asarray(concept),
                                 lora=lora, lora_alpha=0.7)
    with torch.inference_mode():
        out = te(torch.from_numpy(ids).long(), torch.from_numpy(concept),
                 lora_from_jax(lora, 'cpu'), 0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('hw', [8, 32])
def test_unet_eval_matches_jax(bundle, hw):
    """One tiny UNet eval with LoRA on every attention linear and hoisted
    cross K/V, on the sampling pipelines' route (fuse_attention='packed'):
    at 32x32 the res-32 self-attention has 1024 keys and takes the K1 route
    (attention_packed with the LoRA folded into the weights)."""
    ucfg = zoo.tiny_configs()[0]
    unet = load_jax_params(UNet(ucfg, 'cpu'), bundle.unet)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, hw, hw, 4)).astype(np.float32)
    ehs = rng.normal(0, 1, (2, 16, 77, ucfg.cross_attention_dim)) \
        .astype(np.float32)
    t = np.asarray([999, 421], np.int32)
    lora = _lora(bundle.unet, lambda p: '/attn1/' in p or '/attn2/' in p, 3)
    jkv = junet.cross_attention_kv(bundle.unet, jnp.asarray(ehs), ucfg,
                                   lora=lora, alpha=0.8)
    ref, _ = junet.unet_apply(bundle.unet, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ehs), ucfg, lora=lora,
                              lora_alpha=0.8, cross_kv=jkv)
    plora = lora_from_jax(lora, 'cpu')
    e = torch.from_numpy(ehs)
    with torch.inference_mode():
        kv = unet.cross_attention_kv(e, plora, 0.8)
        out = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), e, plora, 0.8, cross_kv=kv,
                   fuse_attention='packed')
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_vae_decode_matches_jax(bundle):
    vcfg = zoo.tiny_configs()[2]
    vae = load_jax_params(AutoencoderKL(vcfg, 'cpu'), bundle.vae)
    z = np.random.default_rng(2).normal(0, 1, (2, 16, 16, 4)) \
        .astype(np.float32)
    ref = jvae.vae_decode(bundle.vae, jnp.asarray(z), vcfg)
    with torch.inference_mode():
        out = vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert out.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize('stats', ['onepass', 'kernel'])
def test_norms_match_jax(stats):
    rng = np.random.default_rng(11)
    x = rng.normal(0.5, 2, (2, 16, 8, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (64,)).astype(np.float32)
    p = {'scale': scale, 'bias': bias}
    gn = torch.nn.GroupNorm(8, 64, eps=1e-6)
    ln = torch.nn.LayerNorm(64)
    for m in (gn, ln):
        m.weight.data = torch.from_numpy(scale)
        m.bias.data = torch.from_numpy(bias)
    ref = jlayers.group_norm(p, jnp.asarray(x), 8, eps=1e-6, act='silu')
    with torch.no_grad():
        out = layers.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), gn,
                                act='silu', stats=stats)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)
    ref = jlayers.layer_norm(p, jnp.asarray(x))
    with torch.no_grad():
        out = layers.layer_norm(torch.from_numpy(x), ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_merge_into_matches_unmerged_lora(bundle):
    """Folding a LoRA tree into the weights (in place) gives the unmerged
    forward."""
    ucfg = zoo.tiny_configs()[0]
    lora = lora_from_jax(_lora(bundle.unet, lambda p: '/attn' in p
                               or 'proj_in' in p, 4), 'cpu')
    unet = load_jax_params(UNet(ucfg, 'cpu'), bundle.unet)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 8, 8)).astype(np.float32))
    e = torch.from_numpy(rng.normal(0, 1, (1, 77, 64)).astype(np.float32))
    t = torch.tensor([500])
    with torch.inference_mode():
        want = unet(x, t, e, lora, 0.6)
    merged = merge_into(unet, lora, 0.6)
    with torch.inference_mode():
        got = merged(x, t, e)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_load_jax_params_layouts_and_missing_keys(bundle):
    sd = state_dict_from_jax(bundle.unet)
    k = np.asarray(bundle.unet['conv_in']['kernel'])          # HWIO
    np.testing.assert_array_equal(sd['conv_in.weight'].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = np.asarray(bundle.unet['time_embedding']['linear_1']['kernel'])
    np.testing.assert_array_equal(
        sd['time_embedding.linear_1.weight'].numpy(), d.T)
    assert 'norm_out.weight' in sd and 'norm_out.scale' not in sd
    te = state_dict_from_jax(bundle.text_encoder)
    assert te['token_embedding.weight'].shape == (49408, 64)
    partial = dict(bundle.unet)
    del partial['conv_out']
    with pytest.raises(KeyError, match='conv_out'):
        load_jax_params(UNet(zoo.tiny_configs()[0], 'cpu'), partial)


def test_zoo_random_init_is_seeded_and_explicit():
    a = zoo.load_models('random:tiny', 'cpu', seed=4)
    b = zoo.load_models('random:tiny', 'cpu', seed=4)
    for (n, p), (_, q) in zip(a.unet.state_dict().items(),
                              b.unet.state_dict().items()):
        assert torch.equal(p, q), n
    w = a.unet.conv_in.weight
    assert w.abs().max() <= 1 / np.sqrt(4 * 9) + 1e-6
    assert torch.equal(a.unet.norm_out.weight,
                       torch.ones_like(a.unet.norm_out.weight))
    with pytest.raises(ValueError):
        zoo.load_models('random:tiny', None)
    with pytest.raises(ValueError):
        zoo.load_models('/no/such/checkpoint', 'cpu')
