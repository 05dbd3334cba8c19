"""Attention capture in the port (utils/ptp.py, EDLoRAPipeline.set_controller)
against the JAX package on the CPU.

The same tiny weights (the JAX package's random:tiny, carried across with
convert.load_jax_params) and latents go through both pipelines in fp32 with
an AttentionStore attached: the stored layers, the averaged maps and
`aggregate_attention` agree within atol 3e-4 / rtol 1e-3 (whole-graph
parity). The store's host code is a copy, so on the same maps it gives the
same numbers and the same PIL strip. With a controller the port's images
equal those without one; `submit()` and the regional pipeline refuse a
controller; a controller's `step_callback` is called once a step and what
it returns replaces the latents, as in the JAX package's stepwise loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixofshow_tpu.models.unet import \
    cross_layer_query_sizes as jcross_layer_query_sizes
from mixofshow_tpu.pipelines import EDLoRAPipeline as JPipeline
from mixofshow_tpu.pipelines import init_concepts as jinit
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.utils import ptp as jptp
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import load_jax_params
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet,
                                        UNetConfig)
from mixofshow_tpu_torch.models.unet import cross_layer_query_sizes
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline,
                                           init_concepts)
from mixofshow_tpu_torch.text import CLIPTokenizer
from mixofshow_tpu_torch.utils import ptp

GRAPH_TOL = dict(atol=3e-4, rtol=1e-3)
PROMPTS = ['a photo of <g1> at the beach', 'a <g2> in a garden']


@pytest.fixture(scope='module')
def pipes():
    b = jload('random:tiny', seed=0)
    u, c, v = zoo.tiny_configs()
    base = np.asarray(b.text_encoder['token_embedding'])
    jtok = JTokenizer()
    jcfg, jtab = jinit(jtok, '<g1>+<g2>', None, base)
    jpipe = JPipeline(b.unet, b.text_encoder, b.vae, tokenizer=jtok,
                      unet_config=u, text_config=c, vae_config=v,
                      new_concept_cfg=jcfg, concept_embedding=jtab,
                      dtype=jnp.float32)
    tok = CLIPTokenizer()
    cfg, table = init_concepts(tok, '<g1>+<g2>', None, base)
    pipe = EDLoRAPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(c, 'cpu'), b.text_encoder),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), tok, 'cpu',
        dtype=torch.float32, new_concept_cfg=cfg, concept_embedding=table)
    return jpipe, pipe


def _latents(b, h, w, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, 4, h, w)).astype(
        np.float32)


@pytest.mark.parametrize('h,w', [(8, 8), (8, 16), (5, 7)])
def test_cross_layer_query_sizes_match_jax(h, w):
    for cfg in (UNetConfig.tiny(), UNetConfig.sd15()):
        assert cross_layer_query_sizes(cfg, h, w) == \
            jcross_layer_query_sizes(cfg, h, w)
    sd15 = cross_layer_query_sizes(UNetConfig.sd15(), 64, 64)
    assert len(sd15) == 16 and sum(q <= 32 ** 2 for *_, q in sd15) == 11


@pytest.mark.parametrize('hw', [(64, 64), (64, 128)])
def test_attention_store_matches_jax(pipes, hw):
    """Two steps of two prompts with CFG, a store that keeps maps of at most
    4² queries: the same layers, averaged maps and aggregate_attention."""
    jpipe, pipe = pipes
    height, width = hw
    lat = _latents(2, height // 8, width // 8)
    kw = dict(height=height, width=width, num_inference_steps=2,
              guidance_scale=4.0, latents=lat, output_type='np')
    jstore, store = jptp.AttentionStore(max_size=4), ptp.AttentionStore(
        max_size=4)
    jpipe.set_controller(jstore)
    pipe.set_controller(store)
    try:
        want_img = jpipe(PROMPTS, **kw)
        got_img = pipe(PROMPTS, **kw)
    finally:
        jpipe.set_controller(None)
        pipe.set_controller(None)
    np.testing.assert_allclose(got_img, want_img, atol=2e-3)
    assert store.cur_step == jstore.cur_step == 2
    want, got = jstore.get_average_attention(), store.get_average_attention()
    assert sorted(got) == sorted(want)
    layers = [q for *_, q in cross_layer_query_sizes(pipe.unet.cfg,
                                                     height // 8, width // 8)
              if q <= 16]
    assert sum(len(m) for m in got.values()) == len(layers)
    for key in want:
        assert [m.shape for m in got[key]] == [m.shape for m in want[key]]
        for g, w in zip(got[key], want[key]):
            assert g.dtype == np.float32 and g.shape[0] == 4
            np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-5)
            np.testing.assert_allclose(g, w, **GRAPH_TOL)
    if hw == (64, 64):   # 4x4 maps: down 1 and up 2
        for where in (('down',), ('up', 'down')):
            np.testing.assert_allclose(
                ptp.aggregate_attention(store, 4, where, select=1,
                                        batch_size=2),
                jptp.aggregate_attention(jstore, 4, where, select=1,
                                         batch_size=2), **GRAPH_TOL)


def test_store_host_code_is_the_jax_copy():
    """store_step, store_summed, get_average_attention, aggregate_attention
    and show_cross_attention on the same numpy maps."""
    rng = np.random.default_rng(3)

    def maps():
        out = []
        for i, (place, q) in enumerate([('down', 16), ('down', 64),
                                        ('mid', 4), ('up', 16)]):
            p = rng.uniform(0, 1, (2, 2, q, 77)).astype(np.float32)
            out.append((place, i, p / p.sum(-1, keepdims=True)))
        return out
    stores = [ptp.AttentionStore(training=False),
              ptp.AttentionStore(max_size=4)], \
        [jptp.AttentionStore(training=False), jptp.AttentionStore(max_size=4)]
    steps = [maps(), maps()]
    summed = [(p, i, a + b) for (p, i, a), (_, _, b) in zip(maps(), maps())]
    for group in stores:
        for s in group:
            for step in steps:
                s.store_step(step)
            s.store_summed(summed, 2)
    for got, want in zip(*stores):
        assert got.max_size == want.max_size and got.cur_step == 4
        a, b = got.get_average_attention(), want.get_average_attention()
        assert sorted(a) == sorted(b)
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            ptp.aggregate_attention(got, 4, ('down', 'up'), 1, 2),
            jptp.aggregate_attention(want, 4, ('down', 'up'), 1, 2))
        tokens = ['<start>', 'a', 'dog']
        assert ptp.show_cross_attention(got, 4, ('up',), tokens).tobytes() \
            == jptp.show_cross_attention(want, 4, ('up',), tokens).tobytes()
    assert ptp.AttentionStore(training=True).max_size == 64
    assert ptp.AttentionStore().max_size == 32


def test_controller_leaves_the_images_alone(pipes):
    _, pipe = pipes
    kw = dict(height=64, width=64, num_inference_steps=2, guidance_scale=4.0,
              latents=_latents(2, 8, 8, seed=1), output_type='uint8')
    plain = pipe(PROMPTS, **kw)
    pipe.set_controller(ptp.AttentionStore(max_size=8))
    try:
        with_store = pipe(PROMPTS, **kw)
    finally:
        pipe.set_controller(None)
    np.testing.assert_array_equal(with_store, plain)


def test_submit_and_regional_refuse_a_controller(pipes):
    _, pipe = pipes
    pipe.set_controller(ptp.AttentionStore())
    try:
        with pytest.raises(ValueError, match='controller'):
            pipe.submit(PROMPTS, height=64, width=64, num_inference_steps=1)
    finally:
        pipe.set_controller(None)
    regional = RegionallyT2IAdapterPipeline(
        pipe.unet, pipe.text_encoder, pipe.vae, pipe.tokenizer, 'cpu',
        torch.float32, new_concept_cfg=pipe.new_concept_cfg,
        concept_embedding=pipe.concept_embedding)
    regional.set_controller(ptp.AttentionStore())
    with pytest.raises(ValueError, match='controller'):
        regional([('a lake', [('a <g1>', '', [0, 0, 1, 0.5])])], height=64,
                 width=64, num_inference_steps=1)


class _Scaler:
    """A controller whose step_callback scales the latents (and counts)."""
    max_size = 4

    def __init__(self):
        self.calls = 0

    def step_callback(self, x):
        self.calls += 1
        return x * 0.9

    def store_summed(self, maps, steps):
        self.stored = (len(maps), steps)


def test_step_callback_replaces_the_latents_as_in_jax(pipes):
    """JAX calls step_callback in its stepwise loop (with a callback); the
    port's loop is stepwise always. Both scale the latents every step."""
    jpipe, pipe = pipes
    kw = dict(height=64, width=64, num_inference_steps=2, guidance_scale=4.0,
              latents=_latents(2, 8, 8, seed=2), output_type='np')
    jctl, ctl = _Scaler(), _Scaler()
    jpipe.set_controller(jctl)
    pipe.set_controller(ctl)
    try:
        want = jpipe(PROMPTS, callback=lambda *a: None, **kw)
        got = pipe(PROMPTS, **kw)
    finally:
        jpipe.set_controller(None)
        pipe.set_controller(None)
    assert ctl.calls == jctl.calls == 2
    assert ctl.stored == jctl.stored == (11, 2)
    np.testing.assert_allclose(got, want, atol=2e-3)
    plain = pipe(PROMPTS, **kw)
    assert np.abs(plain - got).max() > 1e-2
