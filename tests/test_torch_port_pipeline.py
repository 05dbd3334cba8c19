"""The whole slice on the CPU: the port's EDLoRAPipeline with the JAX
package's `random:tiny` weights, set up as tools/gen_goldens.py sets up the
JAX pipeline, reproduces tests/goldens/edlora_sample*.npy (atol 2e-3); plus
the rest of the `__call__` surface, and the port's freedom from jax."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import lora as jlora
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import load_jax_params, lora_from_jax
from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
from mixofshow_tpu_torch.pipelines import EDLoRAPipeline, init_concepts
from mixofshow_tpu_torch.text import CLIPTokenizer
from tools.gen_goldens import PROMPT, _fill_up, _latents

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'goldens')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_bundle():
    return jload('random:tiny', seed=0)


def _pipe(b, with_lora=False):
    u, c, v = zoo.tiny_configs()
    tok = CLIPTokenizer()
    cfg, table = init_concepts(tok, '<g1>+<g2>', None,
                               np.asarray(b.text_encoder['token_embedding']))
    kw = {}
    if with_lora:
        lora = _fill_up(jlora.init_lora_tree(
            3, b.unet, lambda p: '/attn1/' in p or '/attn2/' in p, rank=4))
        kw = dict(unet_lora=lora_from_jax(jax.tree.map(np.asarray, lora),
                                          'cpu'), lora_alpha=1.0)
    return EDLoRAPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(c, 'cpu'), b.text_encoder),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae),
        tok, 'cpu', dtype=torch.float32, new_concept_cfg=cfg,
        concept_embedding=table, **kw)


def test_edlora_sampling_golden(jax_bundle):
    img = _pipe(jax_bundle)([PROMPT, 'a castle'], height=64, width=64,
                            num_inference_steps=2, guidance_scale=4.0,
                            latents=_latents(), output_type='np')
    want = np.load(os.path.join(GOLDEN_DIR, 'edlora_sample.npy'))
    assert img.shape == want.shape and img.dtype == np.float32
    np.testing.assert_allclose(img, want, atol=2e-3)


def test_edlora_lora_alpha_golden(jax_bundle):
    img = _pipe(jax_bundle, with_lora=True)(
        [PROMPT], height=64, width=64, num_inference_steps=2,
        guidance_scale=4.0, latents=_latents(1), output_type='np')
    want = np.load(os.path.join(GOLDEN_DIR, 'edlora_sample_lora.npy'))
    np.testing.assert_allclose(img, want, atol=2e-3)


def test_pipeline_matches_jax_with_both_loras(jax_bundle):
    """Unmerged UNet and text LoRA at alpha 0.7, a negative prompt and two
    images per prompt: the port against the JAX pipeline, same weights and
    latents (atol 2e-3, as the goldens)."""
    import jax.numpy as jnp

    from mixofshow_tpu.pipelines import EDLoRAPipeline as JPipeline
    from mixofshow_tpu.pipelines import init_concepts as jinit
    from mixofshow_tpu.text import CLIPTokenizer as JTokenizer

    b = jax_bundle
    u, c, v = zoo.tiny_configs()
    ulora = jax.tree.map(np.asarray, _fill_up(jlora.init_lora_tree(
        3, b.unet, lambda p: '/attn' in p, rank=4)))
    tlora = jax.tree.map(lambda a: np.asarray(a) + 0.02, jlora.init_lora_tree(
        5, b.text_encoder, lambda p: '/attn/' in p, rank=4))
    base = np.asarray(b.text_encoder['token_embedding'])
    jtok = JTokenizer()
    jcfg, jtab = jinit(jtok, '<g1>+<g2>', None, base)
    jpipe = JPipeline(b.unet, b.text_encoder, b.vae, tokenizer=jtok,
                      unet_config=u, text_config=c, vae_config=v,
                      new_concept_cfg=jcfg, concept_embedding=jtab,
                      unet_lora=ulora, text_lora=tlora, lora_alpha=0.7,
                      dtype=jnp.float32)
    tok = CLIPTokenizer()
    cfg, table = init_concepts(tok, '<g1>+<g2>', None, base)
    pipe = EDLoRAPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(c, 'cpu'), b.text_encoder),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), tok, 'cpu',
        dtype=torch.float32, new_concept_cfg=cfg, concept_embedding=table,
        unet_lora=lora_from_jax(ulora, 'cpu'),
        text_lora=lora_from_jax(tlora, 'cpu'), lora_alpha=0.7)
    kw = dict(height=64, width=64, num_inference_steps=3, guidance_scale=5.0,
              negative_prompt='blurry', num_images_per_prompt=2,
              latents=_latents(4), output_type='np')
    want = jpipe([PROMPT, 'a <g2> castle'], **kw)
    got = pipe([PROMPT, 'a <g2> castle'], **kw)
    assert got.shape == want.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_call_surface(jax_bundle):
    """NCHW and NHWC latents, prompt_embeds, num_images_per_prompt, the
    callback, uint8 and latent outputs, and submit() agree with __call__."""
    pipe = _pipe(jax_bundle)
    kw = dict(height=64, width=64, num_inference_steps=3, guidance_scale=4.0)
    lat = _latents(2)                                          # NCHW
    base = pipe([PROMPT, 'a castle'], latents=lat, output_type='np', **kw)

    nhwc = pipe([PROMPT, 'a castle'], latents=lat.transpose(0, 2, 3, 1),
                output_type='np', **kw)
    np.testing.assert_array_equal(nhwc, base)

    embeds = pipe.encode_prompt([PROMPT, 'a castle'])
    assert embeds.shape == (4, 16, 77, 64)
    np.testing.assert_allclose(
        pipe(prompt_embeds=embeds, latents=lat, output_type='np', **kw),
        base, atol=1e-6)

    seen = []
    u8 = pipe([PROMPT, 'a castle'], latents=lat, output_type='uint8',
              callback=lambda i, t, x: seen.append((i, t, tuple(x.shape))),
              callback_steps=2, **kw)
    assert [s[0] for s in seen] == [0, 2] and seen[0][2] == (2, 4, 8, 8)
    assert seen[0][1] == 999
    np.testing.assert_array_equal(u8, np.round(base * 255).astype(np.uint8))

    pending = pipe.submit([PROMPT, 'a castle'], latents=lat,
                          output_type='uint8', **kw)
    np.testing.assert_array_equal(pending.result(), u8)

    # two images per prompt: repeats grouped per prompt
    lat4 = np.concatenate([lat[:1], lat[:1], lat[1:], lat[1:]])
    rep = pipe([PROMPT, 'a castle'], num_images_per_prompt=2, latents=lat4,
               output_type='np', **kw)
    # (a batch of 4 sums in another order than a batch of 2: fp32 ulps)
    np.testing.assert_allclose(rep[::2], base, atol=1e-5)
    np.testing.assert_allclose(rep[1::2], base, atol=1e-5)

    latent = pipe([PROMPT, 'a castle'], latents=lat, output_type='latent',
                  **kw)
    assert latent.shape == (2, 4, 8, 8) and latent.dtype == np.float32


def test_seeded_noise_is_reproducible(jax_bundle):
    pipe = _pipe(jax_bundle)
    kw = dict(height=64, width=64, num_inference_steps=2, output_type='np')
    a = pipe('a castle', seed=3, **kw)
    np.testing.assert_array_equal(a, pipe('a castle', seed=3, **kw))
    assert not np.array_equal(a, pipe('a castle', seed=4, **kw))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every port module (except the Triton one, which imports
    triton and is loaded only for CUDA tensors) leaves jax and mixofshow_tpu
    out of sys.modules."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import mixofshow_tpu_torch as pkg\n'
        'names = [m.name for m in pkgutil.walk_packages(pkg.__path__, '
        "pkg.__name__ + '.') if not m.name.endswith('_triton')]\n"
        'for n in names: importlib.import_module(n)\n'
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'mixofshow_tpu.')) or m == 'mixofshow_tpu')\n"
        "assert len(names) >= 20, names\n"
        "print(len(names), bad)\n"
        'sys.exit(1 if bad else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
