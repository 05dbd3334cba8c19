"""Regional sampling in the port, held against the JAX package on the CPU.

The same numpy inputs and the JAX package's `random:tiny` weights (carried
across with convert.load_jax_params) go through both packages, fp32:
rasterization and the weight-spec parser exactly; region attention at atol
2e-4 / rtol 1e-3 (the JAX suite's bound between its Pallas kernel and its
XLA path); the adapter and the UNet at atol 3e-4 / rtol 1e-3 (whole-graph
parity); sampled images at atol 2e-3 (the goldens' bound). The port's
`tests/goldens/regional_sample.npy` replay is set up as tools/gen_goldens.py
sets up the JAX run, with the JAX `seed=5` latents passed in."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import t2i_adapter as jt2i
from mixofshow_tpu.models import unet as junet
from mixofshow_tpu.ops import region_attention as jra
from mixofshow_tpu.pipelines import RegionallyT2IAdapterPipeline as JPipeline
from mixofshow_tpu.pipelines import init_concepts as jinit
from mixofshow_tpu.pipelines import pipeline_regional as jpr
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.convert import load_jax_params
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel,
                                        T2IAdapter, T2IAdapterConfig, UNet)
from mixofshow_tpu_torch.models import t2i_adapter as pt2i
from mixofshow_tpu_torch.models.unet import Attention
from mixofshow_tpu_torch.ops import region_attention as pra
from mixofshow_tpu_torch.pipelines import (RegionallyT2IAdapterPipeline,
                                           init_concepts)
from mixofshow_tpu_torch.pipelines import pipeline_regional as ppr
from mixofshow_tpu_torch.text import CLIPTokenizer

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'regional_sample.npy')
ATTN_TOL = dict(atol=2e-4, rtol=1e-3)
GRAPH_TOL = dict(atol=3e-4, rtol=1e-3)
CONCEPTS = '<g1> <g2>'


# ------------------------------------------------------------ rasterization
BOXES = np.asarray([
    [0.0, 0.0, 1.0, 0.5], [0.25, 0.5, 0.75, 1.0],     # edges, halves
    [0.35, 0.35, 0.65, 0.95], [0.02, 0.05, 0.95, 0.30],
    [0.02, 0.35, 0.95, 0.62], [0.02, 0.68, 0.95, 0.97],
    [0.6, 0.6, 0.4, 0.4], [0.5, 0.2, 0.5, 0.9],       # empty
    [0.1, 0.1, 0.12, 0.13], [0.0, 0.0, 1.0, 1.0],     # tiny, whole grid
    [1 / 3, 1 / 7, 2 / 3, 6 / 7], [0.3, 0.7, 0.9, 0.99]], np.float32)


@pytest.mark.parametrize('h,w', [(64, 64), (32, 32), (16, 16), (8, 8),
                                 (20, 20), (12, 20), (7, 5), (1, 3)])
def test_rasterization_matches_jax_exactly(h, w):
    want = np.asarray(jra.boxes_to_grid(jnp.asarray(BOXES), h, w))
    got = pra.boxes_to_grid(BOXES, h, w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # from Python floats too, as the pipeline receives them
    np.testing.assert_array_equal(pra.boxes_to_grid(BOXES.tolist(), h, w),
                                  want)
    for box, px in zip(BOXES, got):
        np.testing.assert_array_equal(
            pra.box_mask(px, h, w, 'cpu').numpy(),
            np.asarray(jpr._box_mask(jnp.asarray(box), h, w)))


def test_rasterization_rounds_in_float32():
    """0.35 * 20 is 7.000000000000001 in float64 but 7 in float32."""
    assert pra.boxes_to_grid([[0.35, 0.35, 0.35, 0.35]], 20, 20)[0, 0] == 7


@pytest.mark.parametrize('spec,size', [
    ('', (512, 512, 8, 8)),
    ('[0, 0, 256, 256]-0.5|[256,256,512,512]-2.0', (512, 512, 8, 8)),
    ('[10, 30, 500, 200]-0.25|[0,0,512,512]-0.125', (512, 512, 64, 64)),
    ('[100, 0, 300, 333]-3', (400, 600, 7, 9)),
])
def test_parse_region_weight_spec_matches_jax(spec, size):
    want = jpr.parse_region_weight_spec(spec, *size, base_weight=0.8)
    got = ppr.parse_region_weight_spec(spec, *size, base_weight=0.8)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_preprocess_adapter_image_matches_jax():
    rng = np.random.default_rng(0)
    rgb = Image.fromarray(rng.integers(0, 256, (50, 70, 3), np.uint8))
    gray = Image.fromarray(rng.integers(0, 256, (40, 40), np.uint8))
    arr = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    for image in (rgb, [rgb, rgb], gray, arr, [arr, arr]):
        want = jt2i.preprocess_adapter_image(image, 64, 48)
        got = pt2i.preprocess_adapter_image(image, 64, 48)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- region attention
ATTN_CASES = [
    (16, 16, [[0.0, 0.0, 1.0, 0.5]]),
    (16, 16, [[0.0, 0.0, 1.0, 0.5], [0.25, 0.25, 0.875, 1.0]]),
    (12, 20, [[0.02, 0.05, 0.95, 0.30], [0.02, 0.35, 0.95, 0.62],
              [0.1, 0.2, 0.9, 0.8]]),
    (8, 8, [[0.5, 0.5, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0],
            [0.3, 0.3, 0.9, 0.9]]),
]


def _attn_inputs(h, w, nr, b=2, heads=2, d=24, sk=77, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    return (f(b, h * w, heads, d), f(b, sk, heads, d), f(b, sk, heads, d),
            f(nr, b, sk, heads, d), f(nr, b, sk, heads, d))


@pytest.mark.parametrize('h,w,boxes', ATTN_CASES)
def test_region_attention_plain_matches_jax_kernel(h, w, boxes):
    """Against the Pallas kernel in interpret mode with fp32 matmuls."""
    q, gk, gv, rk, rv = _attn_inputs(h, w, len(boxes))
    px = pra.boxes_to_grid(boxes, h, w)
    want = jra.region_cross_attention(
        *map(jnp.asarray, (q, gk, gv, rk, rv)), jnp.asarray(px), (h, w), 77,
        precise=True)
    before = pra.region_attention.launches
    got = pra.region_attention(*map(torch.from_numpy, (q, gk, gv, rk, rv)),
                               px, (h, w))
    assert pra.region_attention.launches == before   # CPU: the plain twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def _attn2_params(rng, c, cc):
    def lin(cin, cout, bias=False):
        p = {'kernel': rng.normal(0, 0.08, (cin, cout)).astype(np.float32)}
        if bias:
            p['bias'] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        return p
    return {'to_q': lin(c, c), 'to_k': lin(cc, c), 'to_v': lin(cc, c),
            'to_out': lin(c, c, bias=True)}


# 17 overlapping boxes, a 192-wide head and 129 keys: past K7's limits
# (ops/region_attention.py), so the override takes the dense blend there
SEVENTEEN = np.random.default_rng(9).uniform(0, 1, (17, 4)).astype(np.float32)
SEVENTEEN[:, 2:] = np.maximum(SEVENTEEN[:, :2] + 0.3,
                              SEVENTEEN[:, 2:]).clip(max=1.0)
OVERRIDE_CASES = [pytest.param(*case, 2, 24, 77, id=f'{case[0]}-{case[1]}-'
                               f'boxes{i}')
                  for i, case in enumerate(ATTN_CASES + [(12, 20, [])])] + [
    pytest.param(12, 20, SEVENTEEN.tolist(), 2, 24, 77, id='17-regions'),
    pytest.param(8, 8, ATTN_CASES[2][2], 1, 192, 77, id='head-dim-192'),
    pytest.param(12, 20, ATTN_CASES[1][2], 2, 24, 129, id='129-keys')]


@pytest.mark.parametrize('h,w,boxes,heads,d,sk', OVERRIDE_CASES)
def test_region_override_matches_jax_xla_path(h, w, boxes, heads, d, sk,
                                              monkeypatch):
    """The whole override (projections, region attention, out-projection)
    against JAX `make_region_override(use_kernel=False)`; no regions takes
    the dense attention, and layouts K7 does not take (more than 16 regions,
    D > 160, more than 128 keys) the dense blend on any device: the routing
    is `region_attention_supported`, a shape rule."""
    rng = np.random.default_rng(1)
    c, cc, b = heads * d, 32, 2
    p = _attn2_params(rng, c, cc)
    x = rng.normal(0, 1, (b, h * w, c)).astype(np.float32)
    ctx = rng.normal(0, 1, (b, sk, cc)).astype(np.float32)
    embeds = [rng.normal(0, 1, (b, 16, sk, cc)).astype(np.float32)
              for _ in boxes]
    layer = 3
    want = jpr.make_region_override(
        [(jnp.asarray(e), jnp.asarray(bx, jnp.float32))
         for e, bx in zip(embeds, boxes)], heads, use_kernel=False)(
        p, jnp.asarray(x), jnp.asarray(ctx), layer, 'down', (h, w), None,
        1.0)
    attn2 = load_jax_params(Attention(c, cc, device='cpu'), p)
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)

    def kv(context):
        k = torch.nn.functional.linear(context, attn2.to_k.weight)
        v = torch.nn.functional.linear(context, attn2.to_v.weight)
        return k.view(b, sk, heads, d), v.view(b, sk, heads, d)
    calls = []
    kernel = ppr.region_attention
    monkeypatch.setattr(ppr, 'region_attention',
                        lambda *a: calls.append(1) or kernel(*a))
    override = ppr.make_region_override(
        boxes, heads, {layer: kv(ct)},
        [{layer: kv(torch.from_numpy(e[:, layer]))} for e in embeds])
    with torch.no_grad():
        got = override(attn2, xt, ct, layer, 'down', (h, w), None, 1.0)
    assert bool(calls) == (len(boxes) > 0 and pra.region_attention_supported(
        heads, d, sk, len(boxes)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_region_attention_supported_limits():
    """The shape rule between K7 and the dense blend: 1-16 regions, heads
    up to 160 wide, up to 128 keys."""
    assert not pra.region_attention_supported(8, 40, 129, 3)
    assert not pra.region_attention_supported(8, 320, 77, 3)
    assert pra.region_attention_supported(8, 160, 77, 3)
    assert pra.region_attention_supported(8, 160, 128, 16)
    assert not pra.region_attention_supported(8, 40, 77, 17)
    assert not pra.region_attention_supported(8, 40, 77, 0)


def test_region_attention_raises_on_an_unsupported_device():
    with pytest.raises(ValueError, match='unsupported device'):
        t = torch.zeros(1, 4, 1, 8, device='meta')
        pra.region_attention(t, t, t, t[None], t[None], [[0, 0, 1, 1]],
                             (2, 2))


# ------------------------------------------------------------- the adapter
@pytest.mark.parametrize('in_ch,hw', [(3, (64, 64)), (1, (64, 64)),
                                      (3, (40, 24))])
def test_t2i_adapter_matches_jax(in_ch, hw):
    """40x24 pixels give 5x3 features: the ceil-mode pools see odd sizes."""
    jcfg = jt2i.T2IAdapterConfig.tiny(in_ch)
    params = jt2i.init_t2i_adapter(5, jcfg)
    adapter = load_jax_params(T2IAdapter(T2IAdapterConfig.tiny(in_ch), 'cpu'),
                              params)
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, in_ch)).astype(
        np.float32)
    want = jt2i.t2i_adapter_apply(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = adapter(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(f.shape) for f in got] == [
        (2, f.shape[3], f.shape[1], f.shape[2]) for f in want]
    for g, f in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(f), **GRAPH_TOL)


def test_adapter_zoo_and_param_paths():
    a = zoo.load_t2i_adapter('sketch', 'tiny', 'cpu', seed=3)
    b = zoo.load_t2i_adapter('sketch', 'tiny', 'cpu', seed=3)
    assert a.cfg == T2IAdapterConfig.tiny(1)
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n
    names = set(a.state_dict())
    assert 'body.0.in_conv.weight' not in names        # 32 -> 32
    assert 'body.1.in_conv.weight' in names            # 32 -> 64, 1x1
    assert 'body.3.resnets.0.block2.weight' in names
    with pytest.raises(ValueError):
        zoo.load_t2i_adapter('depth', 'tiny', 'cpu')


# ----------------------------------------------------------------- the UNet
@pytest.fixture(scope='module')
def bundle():
    return jload('random:tiny', seed=0)


def test_unet_with_adapter_and_region_override_matches_jax(bundle):
    ucfg = zoo.tiny_configs()[0]
    unet = load_jax_params(UNet(ucfg, 'cpu'), bundle.unet)
    rng = np.random.default_rng(4)
    b = 2
    x = rng.normal(0, 1, (b, 8, 8, 4)).astype(np.float32)
    ehs = rng.normal(0, 1, (b, 16, 77, 64)).astype(np.float32)
    t = np.asarray([999, 421], np.int32)
    feats = [rng.normal(0, 0.5, (b, 8 >> i, 8 >> i, c)).astype(np.float32)
             for i, c in enumerate(ucfg.block_out_channels)]
    boxes = [[0.0, 0.0, 1.0, 0.5], [0.25, 0.25, 0.875, 1.0]]
    embeds = [rng.normal(0, 1, (b, 16, 77, 64)).astype(np.float32)
              for _ in boxes]
    jover = jpr.make_region_override(
        [(jnp.asarray(e), jnp.asarray(bx, jnp.float32))
         for e, bx in zip(embeds, boxes)], ucfg.attention_heads,
        use_kernel=False)
    want, _ = junet.unet_apply(
        bundle.unet, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), ucfg,
        adapter_features=[jnp.asarray(f) for f in feats],
        cross_attn_override=jover)
    e = torch.from_numpy(ehs)
    with torch.inference_mode():
        over = ppr.make_region_override(
            boxes, ucfg.attention_heads, unet.cross_attention_kv(e),
            [unet.cross_attention_kv(torch.from_numpy(r)) for r in embeds])
        got = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), e,
                   adapter_features=[torch.from_numpy(f).permute(0, 3, 1, 2)
                                     for f in feats],
                   cross_attn_override=over)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **GRAPH_TOL)


# ------------------------------------------------------------ the pipelines
@pytest.fixture(scope='module')
def pipes(bundle):
    """The JAX pipeline as tools/gen_goldens.py builds it (plus a sketch
    adapter), and the port's pipeline over the same weights."""
    b = bundle
    u, c, v = zoo.tiny_configs()
    base = np.asarray(b.text_encoder['token_embedding'])
    kp, sk = jt2i.T2IAdapterConfig.tiny(3), jt2i.T2IAdapterConfig.tiny(1)
    kparams, sparams = jt2i.init_t2i_adapter(7, kp), \
        jt2i.init_t2i_adapter(8, sk)

    jtok = JTokenizer()
    jcfg, table = jinit(jtok, CONCEPTS, None, base)
    te = dict(b.text_encoder)
    te['token_embedding'] = np.concatenate([base, table])
    big = dataclasses.replace(b.text_config,
                              vocab_size=b.text_config.vocab_size
                              + table.shape[0])
    jpipe = JPipeline(b.unet, te, b.vae, tokenizer=jtok,
                      unet_config=b.unet_config, text_config=big,
                      vae_config=b.vae_config, new_concept_cfg=jcfg,
                      keypose_adapter=kparams, keypose_config=kp,
                      sketch_adapter=sparams, sketch_config=sk,
                      dtype=jnp.float32)

    tok = CLIPTokenizer()
    cfg, ptable = init_concepts(tok, CONCEPTS, None, base)
    np.testing.assert_array_equal(ptable, table)
    pc = dataclasses.replace(c, vocab_size=c.vocab_size + ptable.shape[0])
    pipe = RegionallyT2IAdapterPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(pc, 'cpu'), te),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), tok, 'cpu',
        dtype=torch.float32, new_concept_cfg=cfg,
        keypose_adapter=load_jax_params(
            T2IAdapter(T2IAdapterConfig.tiny(3), 'cpu'), kparams),
        sketch_adapter=load_jax_params(
            T2IAdapter(T2IAdapterConfig.tiny(1), 'cpu'), sparams))
    return jpipe, pipe


def _square_pose():
    keypose = np.zeros((64, 64, 3), np.uint8)
    keypose[16:48, 16:48] = 255
    return Image.fromarray(keypose)


def test_regional_sampling_golden(pipes):
    """tests/goldens/regional_sample.npy, set up as tools/gen_goldens.py
    does, with the JAX `seed=5` latents passed in (atol 2e-3)."""
    _, pipe = pipes
    regions = [('a <g1> <g2> person', 'lowres', [0.0, 0.0, 1.0, 0.5]),
               ('a castle', 'blurry', [0.0, 0.5, 1.0, 1.0])]
    lat = np.array(jax.random.normal(jax.random.PRNGKey(5), (1, 8, 8, 4),
                                     jnp.float32))
    ops.reset_launch_counts()
    img = pipe([('two friends at a lake', regions)],
               keypose_adapter_input=[_square_pose()],
               keypose_adaptor_weight=0.8, height=64, width=64,
               num_inference_steps=2, guidance_scale=4.0, latents=lat,
               output_type='np')
    assert set(ops.launch_counts().values()) == {0}    # CPU: no kernel
    want = np.load(GOLDEN)
    assert img.shape == want.shape and img.dtype == np.float32
    np.testing.assert_allclose(img, want, atol=2e-3)


THREE_REGIONS = [('a <g1> <g2> person', 'lowres', [0.02, 0.05, 0.95, 0.30]),
                 ('a castle', 'blurry', [0.02, 0.35, 0.95, 0.62]),
                 ('a tree', '', [0.3, 0.5, 0.95, 0.97])]


def test_pipeline_matches_jax(pipes):
    """3 overlapping regions, keypose and sketch adapters with region
    weight specs, a negative prompt and two images per prompt: the port
    against the JAX pipeline, same weights and latents (atol 2e-3)."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(6)
    sketch = Image.fromarray(rng.integers(0, 256, (64, 64), np.uint8))
    lat = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    kw = dict(keypose_adapter_input=_square_pose(),
              keypose_adaptor_weight=0.9,
              region_keypose_adaptor_weight='[0, 0, 32, 32]-0.5',
              sketch_adapter_input=sketch, sketch_adaptor_weight=0.6,
              region_sketch_adaptor_weight='[16, 16, 64, 40]-1.5|'
                                           '[0, 40, 64, 64]-0.2',
              height=64, width=64, num_inference_steps=3,
              guidance_scale=5.0, negative_prompt='bad quality',
              num_images_per_prompt=2, latents=lat, output_type='np')
    prompt = [('three things near a lake', THREE_REGIONS)]
    want = jpipe(prompt, **kw)
    got = pipe(prompt, **kw)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_encode_region_prompt_matches_jax_and_memoizes(pipes):
    jpipe, pipe = pipes
    prompt = [('two people near a lake', THREE_REGIONS[:2])]
    jpipe._encode_memo = None
    want_pe, want_rl = jpipe.encode_region_prompt(prompt, 'bad quality')
    pipe.set_new_concept_cfg(pipe.new_concept_cfg)
    pe, rl = pipe.encode_region_prompt(prompt, 'bad quality')
    np.testing.assert_allclose(pe.numpy(), np.asarray(want_pe), atol=2e-5)
    assert len(rl) == 2
    for (e, box), (we, wbox) in zip(rl, want_rl):
        np.testing.assert_allclose(e.numpy(), np.asarray(we), atol=2e-5)
        np.testing.assert_array_equal(box, np.asarray(wbox))

    pe2, rl2 = pipe.encode_region_prompt(prompt, 'bad quality')
    assert pe2 is pe and rl2[0][0] is rl[0][0]          # memo hit
    pe3, _ = pipe.encode_region_prompt(prompt, 'other')
    assert pe3 is not pe                                # text change
    np.testing.assert_allclose(pe3[1].numpy(), pe[1].numpy(), atol=2e-5)
    pipe.set_new_concept_cfg(pipe.new_concept_cfg)      # cfg reset
    assert pipe._encode_memo is None


def test_submit_equals_call_and_batches_equal_separate_runs(pipes):
    _, pipe = pipes
    prompt = [('two people near a lake', THREE_REGIONS[:2])]
    lat = np.random.default_rng(7).normal(0, 1, (2, 4, 8, 8)).astype(
        np.float32)                                         # NCHW
    kw = dict(keypose_adapter_input=_square_pose(), height=64, width=64,
              num_inference_steps=2, guidance_scale=4.0)
    batched = pipe(prompt, num_images_per_prompt=2, latents=lat,
                   output_type='np', **kw)
    pending = pipe.submit(prompt, num_images_per_prompt=2, latents=lat,
                          output_type='np', **kw)
    np.testing.assert_array_equal(pending.result(), batched)
    for i in range(2):
        single = pipe(prompt, latents=lat[i:i + 1], output_type='np', **kw)
        # (a batch of 4 sums in another order than a batch of 2: fp32 ulps)
        np.testing.assert_allclose(batched[i:i + 1], single, atol=1e-5)
    assert not np.allclose(batched[0], batched[1], atol=1e-3)
    u8 = pipe(prompt, latents=lat[:1], output_type='uint8', **kw)
    assert u8.dtype == np.uint8 and u8.shape == (1, 64, 64, 3)
    pil = pipe(prompt, latents=lat[:1], **kw)
    np.testing.assert_array_equal(np.asarray(pil[0]), u8[0])
    # no CFG: the layerwise half of the embeddings alone
    plain = pipe(prompt, latents=lat[:1], output_type='np',
                 **dict(kw, guidance_scale=1.0))
    assert plain.shape == (1, 64, 64, 3) and np.isfinite(plain).all()


def test_no_regions_runs_the_dense_cross_attention(pipes):
    _, pipe = pipes
    lat = np.random.default_rng(8).normal(0, 1, (1, 8, 8, 4)).astype(
        np.float32)
    kw = dict(height=64, width=64, num_inference_steps=1, latents=lat,
              output_type='latent')
    base = pipe([('a lake', [])], **kw)
    assert base.shape == (1, 4, 8, 8) and np.isfinite(base).all()
    reg = pipe([('a lake', [('a <g1> <g2>', '', [0.0, 0.0, 1.0, 0.5])])],
               **kw)
    d_in = np.abs(base[..., :4] - reg[..., :4]).mean()
    d_out = np.abs(base[..., 4:] - reg[..., 4:]).mean()
    assert d_in > d_out > 0
