"""The int8 serving modes of the port (ops/quant.py) against the JAX
package's, on the CPU.

The same numpy inputs go through both. The weight quantization and, on the
same activations, the int8 activations and the int32 accumulators are
bitwise JAX's; the rescaled outputs are fp32 products of the same factors
(compared within 1e-6 relative). Over a whole tiny UNet eval every
quantized site, fed the input JAX's site got, gives JAX's output (1e-6
relative) in the same order.

The tiny pipelines in 'int8' and 'int8+conv' are held to JAX's quantized
pipelines with the same weights and latents at PIPE_ATOL, looser than the
goldens' 2e-3: the layers' inputs differ from JAX's by fp32 rounding
(~1e-6), which flips the odd activation across a rounding tie, and one
flip moves its layer's outputs by a whole quantization step (~3e-3 in the
tiny UNet's GEGLU). Each flip feeds the next quantized layers, so at this
size the port's images end up about as far from JAX's quantized images as
quantizing moves them: on one CPU thread 7.4e-3 max (mean 6.8e-4) for the
ED-LoRA images and 5.0e-3 (mean 7.4e-4) for the regional ones in 'int8',
3.7e-2 (4.4e-3) and 2.0e-2 (2.4e-3) in 'int8+conv', where the unquantized
port is 7.7e-3 (1.1e-3), 8.0e-3 (9.6e-4), 4.2e-2 (5.1e-3) and 4.9e-2
(4.6e-3) from them. So no fixed bound on |Δ| can tell a pipeline that
skips quantization from one that quantizes; three more checks do. Every
quantized site of the UNet runs its int8 product in the request (the
hoisted cross K/V and the regional override's to_q and to_out included).
The quantized images are more than 2e-3 (max) from the same port
pipeline's unquantized ones. And they are nearer JAX's quantized images,
in mean |Δ|, than the unquantized ones are (53-87 % of their distance).
`test_pipelines_quantize_the_cast_weights` holds the weights quantized
after the pipeline's cast to JAX's bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import layers as jlayers
from mixofshow_tpu.models.t2i_adapter import init_t2i_adapter
from mixofshow_tpu.ops import quant as jq
from mixofshow_tpu.pipelines import EDLoRAPipeline as JPipeline
from mixofshow_tpu.pipelines import RegionallyT2IAdapterPipeline as JRegional
from mixofshow_tpu.pipelines import init_concepts as jinit
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import load_jax_params
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet,
                                        layers)
from mixofshow_tpu_torch.models import unet as unet_mod
from mixofshow_tpu_torch.models.t2i_adapter import (T2IAdapter,
                                                    T2IAdapterConfig)
from mixofshow_tpu_torch.ops import quant
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline,
                                           init_concepts)
from mixofshow_tpu_torch.text import CLIPTokenizer

PIPE_ATOL = {'int8': 1e-2, 'int8+conv': 5e-2}


def _jax_activation(x, axes):
    """The activation quantization of mixofshow_tpu/ops/quant.py
    (int8_matmul, int8_conv), step for step."""
    xf = jnp.asarray(x, jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=axes, keepdims=True) / 127.0 + 1e-12
    return (np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127)
                       .astype(jnp.int8)), np.asarray(sx))


def _linear(w_in_out, bias=None):
    lin = nn.Linear(*w_in_out.shape, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w_in_out.T))
        if bias is not None:
            lin.bias.copy_(torch.from_numpy(bias))
    return lin


def test_quantize_dense_and_conv_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    w[3, 5] = 0.0
    jd = jq.quantize_dense({'kernel': w})
    lin = quant.quantize_dense(_linear(w))
    np.testing.assert_array_equal(lin.wq.numpy(), jd['wq'].T)
    np.testing.assert_array_equal(lin.wscale.numpy(), jd['wscale'])
    assert lin.wq.dtype == torch.int8 and lin.wscale.dtype == torch.float32
    assert 'wq' not in lin.state_dict()       # buffers, not persistent

    k = rng.normal(size=(3, 3, 16, 12)).astype(np.float32)   # HWIO
    jc = jq.quantize_conv({'kernel': k})
    conv = nn.Conv2d(16, 12, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    quant.quantize_conv(conv)
    np.testing.assert_array_equal(conv.wq.numpy(),
                                  jc['wq'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.wscale.numpy(), jc['wscale'])


def test_int8_matmul_matches_jax():
    """Random rows: the int8 activations and their scales bitwise, the
    accumulators bitwise, the outputs against JAX's int8_matmul."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32)
    x[0, 0] = 0.0                                  # an all-zero row
    w = rng.normal(size=(48, 40)).astype(np.float32)
    jd = jq.quantize_dense({'kernel': w})
    lin = quant.quantize_dense(_linear(w))
    xq, sx = quant.quantize_activation(torch.from_numpy(x), -1)
    jxq, jsx = _jax_activation(x, -1)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(sx.numpy(), jsx)
    acc = quant.int_mm(xq.reshape(-1, 48), lin.wq)
    jacc = np.asarray(jnp.dot(jnp.asarray(jxq), jnp.asarray(jd['wq']),
                              preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc.numpy(), jacc.reshape(-1, 40))
    got = quant.int8_matmul(torch.from_numpy(x), lin.wq, lin.wscale)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jd['wq'], jd['wscale']))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_int8_matmul_ties_and_accumulators_through_jax():
    """Each row holds ±127, so its scale is exactly 1 and JAX's
    int8_matmul with unit weight scales returns its int32 accumulators as
    floats; the .5 entries test round half to even on both sides."""
    rng = np.random.default_rng(2)
    x = rng.integers(-120, 120, (5, 32)).astype(np.float32) + 0.5
    x[:, 0] = 127.0
    x[1::2, 0] = -127.0
    wq = rng.integers(-127, 128, (32, 24)).astype(np.int8)
    ones = np.ones(24, np.float32)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), wq, ones))
    got = quant.int8_matmul(torch.from_numpy(x),
                            torch.from_numpy(np.ascontiguousarray(wq.T)),
                            torch.from_numpy(ones))
    np.testing.assert_array_equal(got.numpy(), want)
    even = np.round(x[:, 1:])                       # numpy: half to even
    np.testing.assert_array_equal(
        quant.quantize_activation(torch.from_numpy(x), -1)[0].numpy()[:, 1:],
        even.astype(np.int8))


@pytest.mark.parametrize('stride,padding', [(1, 1), (2, 1), (1, 0)])
def test_int8_conv_matches_jax(stride, padding):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)      # NHWC
    k = rng.normal(size=(3, 3, 16, 12)).astype(np.float32)      # HWIO
    jc = jq.quantize_conv({'kernel': k})
    wq = torch.from_numpy(np.ascontiguousarray(
        jc['wq'].transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    xq, sx = quant.quantize_activation(xt, (1, 2, 3))
    jxq, jsx = _jax_activation(x, (1, 2, 3))
    np.testing.assert_array_equal(xq.numpy().transpose(0, 2, 3, 1), jxq)
    np.testing.assert_array_equal(sx.numpy().reshape(-1), jsx.reshape(-1))
    want = np.asarray(jq.int8_conv(jnp.asarray(x), jc['wq'], jc['wscale'],
                                   stride, padding))
    got = quant.int8_conv(xt, wq, torch.from_numpy(jc['wscale']), stride,
                          padding)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-6, atol=1e-6)
    # the accumulators, through unit scales: each image holds ±127
    x[:, 0, 0, 0] = 127.0
    ones = np.ones(12, np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    want = np.asarray(jq.int8_conv(jnp.asarray(x), jc['wq'], ones, stride,
                                   padding))
    got = quant.int8_conv(xt, wq, torch.from_numpy(ones), stride, padding)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_dense_and_conv_route_on_wq_and_lora_stays_exact():
    """JAX's test_dense_routes_on_wq_and_lora_stays_exact, and the same
    for a conv: the quantized layer equals JAX's routed layer, and the LoRA
    delta on top is the unquantized delta."""
    torch.set_grad_enabled(False)
    try:
        _route_checks(np.random.default_rng(4))
    finally:
        torch.set_grad_enabled(True)


def _route_checks(rng):
    x = rng.normal(size=(3, 16)).astype(np.float32)
    p = {'kernel': rng.normal(size=(16, 8)).astype(np.float32),
         'bias': rng.normal(size=(8,)).astype(np.float32)}
    jlora = {'down': rng.normal(size=(16, 2)).astype(np.float32),
             'up': rng.normal(size=(2, 8)).astype(np.float32)}
    lora = {'down': torch.from_numpy(jlora['down'].T.copy()),
            'up': torch.from_numpy(jlora['up'].T.copy())}
    lin = _linear(p['kernel'], p['bias'])
    xt = torch.from_numpy(x)
    base = layers.dense(xt, lin)
    quant.quantize_dense(lin)
    q = layers.dense(xt, lin)
    assert not torch.allclose(base, q, atol=1e-7)
    want = np.asarray(jlayers.dense(jq.quantize_dense(p), jnp.asarray(x)))
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-6, atol=1e-6)
    delta = layers.dense(xt, lin, lora, 2.0) - q
    np.testing.assert_allclose(delta.numpy(), 2.0 * x @ jlora['down']
                               @ jlora['up'], rtol=1e-4, atol=1e-5)

    xc = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    pc = {'kernel': rng.normal(size=(3, 3, 16, 12)).astype(np.float32),
          'bias': rng.normal(size=(12,)).astype(np.float32)}
    conv = nn.Conv2d(16, 12, 3, padding=1)
    conv.weight.copy_(torch.from_numpy(pc['kernel'].transpose(3, 2, 0, 1)))
    conv.bias.copy_(torch.from_numpy(pc['bias']))
    quant.quantize_conv(conv)
    got = layers.conv2d(torch.from_numpy(xc.transpose(0, 3, 1, 2)), conv)
    want = np.asarray(jlayers.conv2d(jq.quantize_conv(pc), jnp.asarray(xc)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-5, atol=1e-5)


def _jax_sites(tree):
    """The dotted paths of the layers JAX's quantize_unet gave a wq: the
    port's module names (convert/jax_params.py joins the same keys)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if 'wq' in node:
                out.append('.'.join(map(str, path)))
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(tree, ())
    return sorted(out)


@pytest.fixture(scope='module')
def bundle():
    return jload('random:tiny', seed=0)


@pytest.mark.parametrize('mode', ['int8', 'int8+conv'])
def test_quantize_unet_sites_match_jax(bundle, mode):
    convs = mode == 'int8+conv'
    want = _jax_sites(jq.quantize_unet(bundle.unet, convs=convs))
    unet = load_jax_params(UNet(zoo.tiny_configs()[0], 'cpu'), bundle.unet)
    quant.quantize_unet(unet, convs=convs)
    got = sorted(name for name, m in unet.named_modules()
                 if 'wq' in m._buffers)
    assert got == want and len(got) == 16 * 10 + (44 if convs else 0)
    assert sorted(p for p, _ in quant.quantized_sites(unet, convs)) == got
    assert unet.quantize_mode == mode
    quant.set_quantization(unet, None)
    assert unet.quantize_mode is None and not any(
        'wq' in m._buffers for m in unet.modules())
    with pytest.raises(ValueError, match='unknown quantize mode'):
        quant.set_quantization(unet, 'int4')


def test_quantized_attn1_leaves_the_packed_route(bundle, monkeypatch):
    """At 32x32 latents (1024 keys) the packed route (K1) takes attn1 in
    bf16 serving; quantized, attn1's core goes through sdpa's flash
    attention (K4 on the card) instead. Counted on the CPU twins."""
    calls = {'packed': 0, 'flash': 0}
    packed, flash = unet_mod.attention_packed, layers.flash_attention

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(unet_mod, 'attention_packed', count('packed', packed))
    monkeypatch.setattr(layers, 'flash_attention', count('flash', flash))
    unet = load_jax_params(UNet(zoo.tiny_configs()[0], 'cpu'), bundle.unet)
    x = torch.zeros(1, 4, 32, 32)
    ehs = torch.randn(1, 77, 64, generator=torch.Generator().manual_seed(0))
    seen = {}
    for mode in (None, 'int8'):
        quant.set_quantization(unet, mode)
        calls.update(packed=0, flash=0)
        with torch.inference_mode():
            unet(x, torch.tensor([5]), ehs, fuse_attention='packed')
        seen[mode] = dict(calls)
    assert seen[None]['packed'] > 0 and seen[None]['flash'] == 0
    assert seen['int8'] == {'packed': 0, 'flash': seen[None]['packed']}


def _record(calls, module, name, quantized):
    """Wrap module.<name> to append (site, input, output) of the calls on
    quantized layers."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        site = quantized(*args)
        if site is not None:
            calls.append((site, args, out))
        return out
    return wrapped


def test_every_quantized_site_replays_jax(bundle, monkeypatch):
    """One tiny UNet eval (CFG batch, 16x16 latents) in JAX, eagerly, and
    in the port, in 'int8+conv' (its sites hold every 'int8' site): the
    same quantized sites in the same order, each port layer given the input
    JAX's layer got returns JAX's output."""
    import jax
    from mixofshow_tpu.models import unet as junet
    convs = True
    jcalls, pcalls = [], []
    for name in ('dense', 'conv2d'):
        monkeypatch.setattr(junet, name, _record(
            jcalls, junet, name, lambda p, *_: p if 'wq' in p else None))
        monkeypatch.setattr(unet_mod, name, _record(
            pcalls, unet_mod, name,
            lambda x, m, *_: m if 'wq' in m._buffers else None))
    u = zoo.tiny_configs()[0]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ehs = rng.normal(size=(2, 77, 64)).astype(np.float32)
    t = np.asarray([999, 421], np.int32)
    with jax.disable_jit():
        junet.unet_apply(jq.quantize_unet(bundle.unet, convs=convs),
                         jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), u)
    unet = quant.quantize_unet(load_jax_params(UNet(u, 'cpu'), bundle.unet),
                               convs=convs)
    with torch.inference_mode():
        unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
             torch.from_numpy(ehs))
    assert len(jcalls) == len(pcalls) == 16 * 10 + 44
    for (jp, jargs, jy), (mod, pargs, _) in zip(jcalls, pcalls):
        jx = np.asarray(jargs[1])
        conv = isinstance(mod, nn.Conv2d)
        xt = torch.from_numpy(np.array(
            jx.transpose(0, 3, 1, 2) if conv else jx))
        # the same layer at the same input shape
        wq = mod.wq.numpy()
        np.testing.assert_array_equal(
            wq.transpose(2, 3, 1, 0) if conv else wq.T, jp['wq'])
        assert pargs[0].shape == xt.shape
        with torch.inference_mode():
            y = layers.conv2d(xt, mod) if conv else layers.dense(xt, mod)
        got = y.numpy().transpose(0, 2, 3, 1) if conv else y.numpy()
        want = np.asarray(jy)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


def _edlora_pair(b, mode):
    u, c, v = zoo.tiny_configs()
    base = np.asarray(b.text_encoder['token_embedding'])
    jtok = JTokenizer()
    jcfg, jtab = jinit(jtok, '<g1>+<g2>', None, base)
    jpipe = JPipeline(b.unet, b.text_encoder, b.vae, tokenizer=jtok,
                      unet_config=u, text_config=c, vae_config=v,
                      new_concept_cfg=jcfg, concept_embedding=jtab,
                      dtype=jnp.float32, quantize=mode)
    tok = CLIPTokenizer()
    cfg, table = init_concepts(tok, '<g1>+<g2>', None, base)
    pipe = EDLoRAPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(c, 'cpu'), b.text_encoder),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), tok, 'cpu',
        dtype=torch.float32, new_concept_cfg=cfg, concept_embedding=table,
        quantize=mode)
    return jpipe, pipe


def _regional_pair(b, mode):
    u, c, v = zoo.tiny_configs()
    base = np.asarray(b.text_encoder['token_embedding'])
    kp = T2IAdapterConfig.tiny(3)
    kparams = init_t2i_adapter(7, kp)
    jtok = JTokenizer()
    jcfg, table = jinit(jtok, '<g1> <g2>', None, base)
    te = dict(b.text_encoder)
    te['token_embedding'] = np.concatenate([base, table])
    big = dataclasses.replace(b.text_config, vocab_size=b.text_config
                              .vocab_size + table.shape[0])
    jpipe = JRegional(b.unet, te, b.vae, tokenizer=jtok,
                      unet_config=b.unet_config, text_config=big,
                      vae_config=b.vae_config, new_concept_cfg=jcfg,
                      keypose_adapter=kparams, keypose_config=kp,
                      dtype=jnp.float32, quantize=mode)
    tok = CLIPTokenizer()
    cfg, _ = init_concepts(tok, '<g1> <g2>', None, base)
    pc = dataclasses.replace(c, vocab_size=c.vocab_size + table.shape[0])
    pipe = RegionallyT2IAdapterPipeline(
        load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(CLIPTextModel(pc, 'cpu'), te),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), tok, 'cpu',
        dtype=torch.float32, new_concept_cfg=cfg,
        keypose_adapter=load_jax_params(T2IAdapter(kp, 'cpu'), kparams),
        quantize=mode)
    return jpipe, pipe


def _run_every_site_int8(pipe, monkeypatch, *args, **kw):
    """Run the pipeline and check that every quantized site of its UNet ran
    its int8 product (ops.quant through layers.dense/conv2d): the hoisted
    cross K/V and, in regional sampling, the region override's to_q and
    to_out included."""
    sites = {id(m.wq): path for path, m in quant.quantized_sites(
        pipe.unet, convs=pipe.quantize == 'int8+conv')}
    ran = set()

    def record(fn):
        def wrapped(x, wq, *a, **k):
            ran.add(sites[id(wq)])
            return fn(x, wq, *a, **k)
        return wrapped
    for name in ('int8_matmul', 'int8_conv'):
        monkeypatch.setattr(layers, name, record(getattr(layers, name)))
    out = pipe(*args, **kw)
    monkeypatch.undo()
    assert ran == set(sites.values())
    return out


def _assert_quantization_moved(got, want, unquantized):
    """The port's quantized images `got` are more than 2e-3 (max) from the
    same pipeline's unquantized ones and nearer JAX's quantized images
    `want` in mean |Δ| than those are."""
    assert np.abs(unquantized - got).max() > 2e-3
    assert np.abs(got - want).mean() < np.abs(unquantized - want).mean()


@pytest.mark.parametrize('mode', ['int8', 'int8+conv'])
def test_quantized_edlora_pipeline_matches_jax(bundle, mode, monkeypatch):
    jpipe, pipe = _edlora_pair(bundle, mode)
    lat = np.random.default_rng(5).normal(size=(2, 8, 8, 4)).astype(
        np.float32)
    kw = dict(height=64, width=64, num_inference_steps=2, guidance_scale=5.0,
              negative_prompt='blurry', latents=lat, output_type='np')
    prompts = ['a photo of <g1> <g2> on a beach', 'a <g2> castle']
    want = jpipe(prompts, **kw)
    got = _run_every_site_int8(pipe, monkeypatch, prompts, **kw)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=PIPE_ATOL[mode])
    # the serving mode moved the images: the int8 route was taken
    pipe_bf = EDLoRAPipeline(pipe.unet, pipe.text_encoder, pipe.vae,
                             pipe.tokenizer, 'cpu', torch.float32,
                             new_concept_cfg=pipe.new_concept_cfg,
                             concept_embedding=pipe.concept_embedding)
    _assert_quantization_moved(got, want, pipe_bf(prompts, **kw))
    # the UNet now serves unquantized; the int8 pipeline refuses to run
    with pytest.raises(RuntimeError, match='built after it'):
        pipe(prompts, **kw)


@pytest.mark.parametrize('mode', ['int8', 'int8+conv'])
def test_quantized_regional_pipeline_matches_jax(bundle, mode, monkeypatch):
    jpipe, pipe = _regional_pair(bundle, mode)
    keypose = np.zeros((64, 64, 3), np.uint8)
    keypose[16:48, 16:48] = 255
    lat = np.random.default_rng(6).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    regions = [('a <g1> <g2> person', 'lowres', [0.0, 0.0, 1.0, 0.5]),
               ('a castle', 'blurry', [0.1, 0.4, 0.9, 1.0])]
    kw = dict(keypose_adapter_input=Image.fromarray(keypose),
              keypose_adaptor_weight=0.8, height=64, width=64,
              num_inference_steps=2, guidance_scale=4.0, latents=lat,
              output_type='np')
    prompt = [('two friends at a lake', regions)]
    want = jpipe(prompt, **kw)
    got = _run_every_site_int8(pipe, monkeypatch, prompt, **kw)
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=PIPE_ATOL[mode])
    # the serving mode moved the images: the int8 route was taken
    pipe_bf = RegionallyT2IAdapterPipeline(
        pipe.unet, pipe.text_encoder, pipe.vae, pipe.tokenizer, 'cpu',
        torch.float32, new_concept_cfg=pipe.new_concept_cfg,
        keypose_adapter=pipe.keypose_adapter)
    _assert_quantization_moved(got, want, pipe_bf(prompt, **kw))


@pytest.mark.parametrize('cls,jcls', [(EDLoRAPipeline, JPipeline),
                                      (RegionallyT2IAdapterPipeline,
                                       JRegional)],
                         ids=['edlora', 'regional'])
def test_pipelines_quantize_the_cast_weights(bundle, cls, jcls):
    """A bf16 pipeline over fp32 modules quantizes the weights after their
    cast to bf16, as JAX's pipelines quantize their cast tree: every site's
    wq and wscale are JAX's bitwise, and some differ from those of the fp32
    weights."""
    u, c, v = zoo.tiny_configs()
    jpipe = jcls(bundle.unet, bundle.text_encoder, bundle.vae,
                 unet_config=u, text_config=c, vae_config=v,
                 dtype=jnp.bfloat16, quantize='int8+conv')
    want = {}

    def walk(node, path):
        if isinstance(node, dict):
            if 'wq' in node:
                want['.'.join(map(str, path))] = node
            for k, val in node.items():
                walk(val, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, path + (i,))
    walk(jpipe.unet_params, ())
    pipe = cls(load_jax_params(UNet(u, 'cpu'), bundle.unet),
               CLIPTextModel(c, 'cpu'), AutoencoderKL(v, 'cpu'),
               CLIPTokenizer(), 'cpu', torch.bfloat16,
               quantize='int8+conv')
    sites = quant.quantized_sites(pipe.unet, convs=True)
    assert sorted(p for p, _ in sites) == sorted(want)
    fp32 = dict(load_jax_params(UNet(u, 'cpu'), bundle.unet).named_modules())
    differs = 0
    for path, m in sites:
        wq = m.wq.numpy()
        wq = wq.transpose(2, 3, 1, 0) if wq.ndim == 4 else wq.T
        np.testing.assert_array_equal(wq, np.asarray(want[path]['wq']))
        np.testing.assert_array_equal(m.wscale.numpy(),
                                      np.asarray(want[path]['wscale']))
        w32 = fp32[path].weight
        differs += not torch.equal(
            quant._quantize_weight(w32, tuple(range(1, w32.dim())))[0], m.wq)
    assert differs > 0


def test_pipelines_refuse_an_unknown_mode(bundle):
    u, c, v = zoo.tiny_configs()
    mods = (UNet(u, 'cpu'), CLIPTextModel(c, 'cpu'), AutoencoderKL(v, 'cpu'))
    for cls in (EDLoRAPipeline, RegionallyT2IAdapterPipeline):
        with pytest.raises(ValueError, match="unknown quantize mode: 'int4'"):
            cls(*mods, CLIPTokenizer(), 'cpu', torch.float32,
                quantize='int4')


def test_trainer_runs_the_weights_of_a_quantized_unet(bundle):
    """The trainer drops a serving quantization on the modules it takes."""
    from mixofshow_tpu_torch.pipelines.trainer_edlora import EDLoRATrainer
    u, c, v = zoo.tiny_configs()
    unet = quant.quantize_unet(UNet(u, 'cpu'))
    EDLoRATrainer(unet, CLIPTextModel(c, 'cpu'), AutoencoderKL(v, 'cpu'),
                  CLIPTokenizer(), 'cpu', new_concept_token='<t1>+<t2>',
                  compute_dtype=torch.float32)
    assert unet.quantize_mode is None
    assert not any('wq' in m._buffers for m in unet.modules())

