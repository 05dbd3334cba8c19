"""The UNet eval in channels-last, fp32 on the CPU at the tiny config.

Every conv weight of a UNet is `torch.channels_last` whichever way the
module was obtained; one eval runs every convolution on channels-last
input (`layers.conv2d.layouts`), in each form the pipelines, the trainer
and the fusion use; `UNet.forward` hands back contiguous NCHW; the
transformer's tokens are views of its map. There is no NCHW switch to hold
the layout against: the JAX package (NHWC) is the yardstick, at the JAX
suite's tolerances (outputs atol 3e-4 / rtol 1e-3; gradients atol 1e-5 +
rtol 1e-3 of the largest entry), here with LoRA on the 1x1 convs too.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import lora as jlora
from mixofshow_tpu.models import unet as junet
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.convert import (load_jax_params,
                                         load_pipeline_params, lora_from_jax,
                                         save_pipeline_params)
from mixofshow_tpu_torch.fusion import gradient_fusion as fusion
from mixofshow_tpu_torch.models import UNet, layers
from mixofshow_tpu_torch.models import unet as unet_mod
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree
from mixofshow_tpu_torch.ops import quant
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline)
from mixofshow_tpu_torch.pipelines.pipeline_regional import \
    make_region_override

CL = torch.channels_last
TOL = dict(atol=3e-4, rtol=1e-3)
U = zoo.tiny_configs()[0]


@pytest.fixture(scope='module')
def bundle():
    return zoo.load_models('random:tiny', 'cpu', seed=0)


@pytest.fixture(scope='module')
def jbundle():
    return jload('random:tiny', seed=0)


def _convs(unet):
    return [m for m in unet.modules() if isinstance(m, nn.Conv2d)]


def _all_channels_last(unet):
    """Every conv weight channels-last on a 16-byte boundary."""
    return all(c.weight.is_contiguous(memory_format=CL) and
               c.weight.data_ptr() % 16 == 0 for c in _convs(unet))


def _inputs(hw=16, rows=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 4, hw, hw, generator=g)
    ehs = torch.randn(rows, 77, U.cross_attention_dim, generator=g)
    return x, torch.tensor([999, 421][:rows]), ehs


# ------------------------------------------------------------ weight layout
def _via_zoo(b, jb, tmp_path):
    return b.unet


def _via_diffusers_dir(b, jb, tmp_path):
    save_pipeline_params(str(tmp_path), unet=b.unet)
    return load_pipeline_params(str(tmp_path), 'cpu')['unet']


def _via_jax_params(b, jb, tmp_path):
    return load_jax_params(UNet(U, 'cpu'), jb.unet)


def _via_fusion_copy(b, jb, tmp_path):
    return fusion._cast_copy(b.unet, torch.bfloat16)


def _via_pipeline(b, jb, tmp_path):
    return EDLoRAPipeline(copy.deepcopy(b.unet), b.text_encoder, b.vae,
                          b.tokenizer, 'cpu', torch.bfloat16).unet


def _via_assigned_state_dict(b, jb, tmp_path):
    """A bf16 module built on the meta device and filled by
    load_state_dict(assign=True) from contiguous tensors carved out of one
    flat buffer, each 8 bytes past a 16-byte boundary (how
    bench_port/build.py fills the program)."""
    sd = {k: t.to(torch.bfloat16) for k, t in b.unet.state_dict().items()}
    flat = torch.empty(sum(-(-t.numel() // 8) * 8 + 8 for t in sd.values()),
                       dtype=torch.bfloat16)
    views, off = {}, 4
    for k, t in sd.items():
        views[k] = flat[off:off + t.numel()].view(t.shape)
        views[k].copy_(t)
        assert views[k].data_ptr() % 16 == 8
        off += -(-t.numel() // 8) * 8 + 8
    unet = UNet(U, 'meta', torch.bfloat16)
    unet.load_state_dict(views, assign=True)
    for k, t in unet.state_dict().items():
        assert torch.equal(t, sd[k]), k
    return unet


@pytest.mark.parametrize('build', [_via_zoo, _via_diffusers_dir,
                                   _via_jax_params, _via_fusion_copy,
                                   _via_pipeline, _via_assigned_state_dict],
                         ids=lambda f: f.__name__[5:])
def test_every_conv_weight_is_channels_last(bundle, jbundle, tmp_path,
                                            build):
    """Each way the repository obtains a UNet leaves every conv weight
    channels-last (a 1x1 weight is both layouts at once) and 16-byte
    aligned, so no call transposes a weight and cuDNN's NHWC kernels take
    every conv."""
    unet = build(bundle, jbundle, tmp_path)
    assert len(_convs(unet)) == 98
    assert _all_channels_last(unet)


def test_channels_last_weights_keep_their_values(bundle):
    """The relayout moves values, never changes them: a copy_-load of NCHW
    tensors leaves the weights channels-last, and the state dict reads the
    same numbers."""
    unet = UNet(U, 'cpu')
    nchw = {k: t.contiguous() for k, t in bundle.unet.state_dict().items()}
    unet.load_state_dict(nchw)
    assert _all_channels_last(unet)
    for k, t in unet.state_dict().items():
        assert torch.equal(t, nchw[k]), k


# ------------------------------------------------------------ eval layouts
def _lora(unet, pred, seed=3):
    tree = init_lora_tree(np.random.default_rng(seed), unet, pred, rank=4)
    for leaf in flatten_lora(tree).values():
        leaf['up'].add_(0.02)
    return tree


def _adapter_pipe(b):
    adapter = zoo.load_t2i_adapter('keypose', 'tiny', 'cpu', seed=3)
    return RegionallyT2IAdapterPipeline(b.unet, b.text_encoder, b.vae,
                                        b.tokenizer, 'cpu', torch.float32,
                                        keypose_adapter=adapter)


def _features(b, hw):
    """The regional pipeline's adapter features for a 2-row CFG eval."""
    img = np.random.default_rng(4).random((1, hw * 8, hw * 8, 3),
                                          dtype=np.float32)
    feats = _adapter_pipe(b)._adapter_features(
        img, 1.0, '', None, 1.0, '', hw * 8, hw * 8, use_cfg=True)
    assert all(f.is_contiguous(memory_format=CL) and not f.is_contiguous()
               for f in feats)
    return feats


def _override(b, ehs):
    kv = b.unet.cross_attention_kv(ehs)
    return make_region_override([[0.0, 0.0, 0.5, 1.0], [0.5, 0.0, 1.0, 1.0]],
                                U.attention_heads, kv, [kv, kv])


FORMS = {
    'plain': lambda b, ehs: {},
    'packed': lambda b, ehs: {'fuse_attention': 'packed'},
    'lora_on_linears_and_1x1_convs': lambda b, ehs: {
        'lora': _lora(b.unet, lambda p: True), 'fuse_attention': 'packed'},
    'adapter_features': lambda b, ehs: {
        'adapter_features': _features(b, 16), 'fuse_attention': 'packed'},
    'cross_attention_override': lambda b, ehs: {
        'cross_attn_override': _override(b, ehs),
        'fuse_attention': 'packed'},
    'gram_capture': lambda b, ehs: {'capture_grams':
                                    unet_mod.ALL_GRAM_POINTS},
    'cross_probs_and_remat': lambda b, ehs: {'return_cross_probs': True,
                                             'remat': True},
}


@pytest.mark.parametrize('form', sorted(FORMS))
def test_every_eval_conv_runs_channels_last(bundle, form):
    """One eval calls each of the UNet's 98 convs once, each on a
    channels-last input, conv_in and conv_out included."""
    x, t, ehs = _inputs()
    kw = FORMS[form](bundle, ehs)
    ops.reset_launch_counts()
    with torch.no_grad():
        bundle.unet(x, t, ehs, **kw)
    assert layers.conv2d.layouts == {'channels_last': 98}


def test_int8_conv_mode_runs_channels_last(bundle):
    """'int8+conv': the int8 resnet convs hand their outputs on
    channels-last too, and their int8 weights stay (O, I·kh·kw) rows."""
    unet = quant.quantize_unet(copy.deepcopy(bundle.unet), convs=True)
    assert all(m.wq.is_contiguous() for _, m in
               quant.quantized_sites(unet, convs=True)
               if isinstance(m, nn.Conv2d))
    x, t, ehs = _inputs()
    ops.reset_launch_counts()
    with torch.no_grad():
        unet(x, t, ehs, fuse_attention='packed')
    assert layers.conv2d.layouts == {'channels_last': 98}


def test_int8_conv_is_layout_free():
    """ops.quant.int8_conv's im2col reads values, not strides: NCHW and
    channels-last inputs give the same numbers, bit for bit."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 9, 7, generator=g)
    w = torch.randn(6, 8, 3, 3, generator=g)
    conv = nn.Conv2d(8, 6, 3, padding=1)
    conv.weight.data = w.contiguous(memory_format=CL)
    quant.quantize_conv(conv)
    got = [quant.int8_conv(x.contiguous(memory_format=fmt), conv.wq,
                           conv.wscale, 1, 1)
           for fmt in (torch.contiguous_format, CL)]
    assert torch.equal(got[0], got[1])


def test_vae_and_counter_reset(bundle):
    """The VAE stays NCHW (K8 walks NCHW planes): its convs count as
    'other'; ops.reset_launch_counts empties the counter."""
    lat = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(6))
    ops.reset_launch_counts()
    with torch.no_grad():
        bundle.vae.decode(lat)
    assert set(layers.conv2d.layouts) == {'other'}
    ops.reset_launch_counts()
    assert layers.conv2d.layouts == {}


# ------------------------------------------------------------ the boundary
def test_forward_returns_contiguous_nchw_for_either_input_layout(bundle):
    x, t, ehs = _inputs()
    with torch.no_grad():
        outs = [bundle.unet(x.contiguous(memory_format=fmt), t, ehs,
                            fuse_attention='packed')
                for fmt in (torch.contiguous_format, CL)]
        out, aux = bundle.unet(x, t, ehs, capture_grams=True)
    for o in outs + [out]:
        assert o.shape == x.shape and o.is_contiguous()
        assert not o.is_contiguous(memory_format=CL)
    assert torch.equal(outs[0], outs[1])


def test_transformer_tokens_are_views_of_the_map(bundle, monkeypatch):
    """proj_in's channels-last output is read as (B, HW, C) rows in place
    (ln1 normalizes the very memory proj_in wrote), and proj_out reads the
    rows back as a channels-last map."""
    seen = []
    inner = unet_mod.conv2d

    def record(x, conv, lora=None, alpha=1.0):
        y = inner(x, conv, lora, alpha)
        seen.append((conv, x.is_contiguous(memory_format=CL), y.data_ptr()))
        return y

    monkeypatch.setattr(unet_mod, 'conv2d', record)
    rows = []
    ln = unet_mod.layer_norm
    monkeypatch.setattr(unet_mod, 'layer_norm', lambda h, n: (
        rows.append(h.data_ptr()), ln(h, n))[1])
    x, t, ehs = _inputs()
    with torch.no_grad():
        bundle.unet(x, t, ehs)
    tfms = [m for _, m in bundle.unet._transformers()]
    proj_in = [y for c, _, y in seen if any(c is m.proj_in for m in tfms)]
    proj_out = [cl for c, cl, _ in seen
                if any(c is m.proj_out for m in tfms)]
    assert len(proj_in) == len(proj_out) == len(tfms) == 16
    # three LayerNorms a transformer, ln1 first
    assert len(rows) == 48 and rows[0::3] == proj_in
    assert all(proj_out)


# ------------------------------------------------------------ against JAX
def _conv_lora(jparams, seed):
    """A JAX LoRA tree on every transformer linear and 1x1 conv, up
    non-zero."""
    tree = jlora.init_lora_tree(seed, jparams, lambda p: 'attention' in p,
                                rank=4)
    return jax.tree.map(lambda a: np.asarray(a) + 0.03, tree)


def test_eval_with_1x1_conv_lora_matches_jax(jbundle):
    """A tiny eval at 32x32 (res-32 self-attention on the K1 route) with
    LoRA on every linear and on proj_in/proj_out, against the JAX
    package's NHWC eval."""
    unet = load_jax_params(UNet(U, 'cpu'), jbundle.unet)
    lora = _conv_lora(jbundle.unet, 7)
    assert any('proj_in' in p for p in flatten_lora(lora))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    ehs = rng.normal(size=(2, 77, U.cross_attention_dim)).astype(np.float32)
    t = np.asarray([999, 421], np.int32)
    # jitted: op-by-op dispatch of the JAX UNet takes ~3x longer
    ref = jax.jit(lambda p, x, t, e, l: junet.unet_apply(
        p, x, t, e, U, lora=l, lora_alpha=0.8)[0])(
            jbundle.unet, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
            lora)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ehs),
                   lora_from_jax(lora, 'cpu'), 0.8,
                   fuse_attention='packed')
    assert layers.conv2d.layouts == {'channels_last': 98}
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_lora_gradients_through_channels_last_convs_match_jax(jbundle):
    """The gradient of a tiny loss on every LoRA leaf (linears and the 1x1
    proj convs) flows back through channels-last convs and matches
    jax.grad of the NHWC eval."""
    unet = load_jax_params(UNet(U, 'cpu'), jbundle.unet).requires_grad_(
        False)
    lora = _conv_lora(jbundle.unet, 9)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ehs = rng.normal(size=(1, 77, U.cross_attention_dim)).astype(np.float32)
    w = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)

    def jloss(tree):
        out, _ = junet.unet_apply(jbundle.unet, jnp.asarray(x),
                                  jnp.asarray([300]), jnp.asarray(ehs), U,
                                  lora=tree, lora_alpha=1.0)
        return jnp.sum(out * jnp.asarray(w))

    want = flatten_lora(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
        jax.tree.map(jnp.asarray, lora))))
    plora = lora_from_jax(lora, 'cpu')
    for leaf in flatten_lora(plora).values():
        for p in leaf.values():
            p.requires_grad_()
    out = unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor([300]),
               torch.from_numpy(ehs), plora, 1.0)
    (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    got = flatten_lora(plora)
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for leaf in want.values()
                for v in leaf.values())
    for path, leaf in got.items():
        # the port's leaves are (r, in) / (out, r), JAX's their transposes
        for name in ('down', 'up'):
            np.testing.assert_allclose(leaf[name].grad.numpy(),
                                       want[path][name].T, rtol=1e-3,
                                       atol=1e-5 + 1e-3 * scale,
                                       err_msg=f'{path}/{name}')
