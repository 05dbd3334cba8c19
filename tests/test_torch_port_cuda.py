"""The port's kernels on the card, against their plain PyTorch versions.

These need an NVIDIA GPU (Hopper, sm_90a) with nvcc and triton, and skip
elsewhere. This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: bf16 kernels against the fp32 plain version on the same bf16
inputs 3e-2 (P and the output round to bf16); fp32 kernels 1e-5; fp32 sums
relative 1e-4 of the sum of magnitudes.
"""
import copy

import numpy as np
import pytest
import torch

from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.ops import fused_attention as fa
from mixofshow_tpu_torch.ops import gn_stats as gs
from mixofshow_tpu_torch.ops import region_attention as ra
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline,
                                           init_concepts)
from mixofshow_tpu_torch.utils.device import exact_fp32

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def _randn(dev, *shape, dtype, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,h,d,kv_len', [
    (2, 100, 130, 2, 16, 77), (1, 256, 256, 2, 40, 256),
    (2, 1024, 1024, 8, 80, 1024), (1, 64, 77, 3, 24, 77),
    (1, 200, 200, 2, 160, 199), (1, 300, 300, 1, 512, 290),
    (1, 70, 90, 2, 100, 90)])
def test_attn_fwd_matches_plain(dev, dtype, b, sq, sk, h, d, kv_len):
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=1)
    k = _randn(dev, b, sk, h, d, dtype=dtype, seed=2)
    v = _randn(dev, b, sk, h, d, dtype=dtype, seed=3)
    before = fa.attn_fwd.launches
    out = fa.attn_fwd(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert fa.attn_fwd.launches == before + 1
    ref = fa.attn_fwd_plain(q.float(), k.float(), v.float(), kv_len)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=0)


def test_attn_fwd_reads_strided_views(dev):
    """q/k/v as column slices of one fused (B, S, 3C) tensor."""
    qkv = _randn(dev, 2, 300, 3 * 64, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 300, 2, 32) for t in qkv.split(64, dim=-1))
    ref = fa.attn_fwd_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(fa.attn_fwd(q, k, v).float(), ref,
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,c,heads,biases', [
    (2, 1024, 1024, 512, 1, True), (1, 100, 77, 64, 2, False),
    (2, 300, 300, 32, 1, True)])
def test_attention_block_matches_plain(dev, dtype, b, sq, sk, c, heads,
                                       biases):
    x = _randn(dev, b, sq, c, dtype=dtype, seed=1)
    ctx = x if sq == sk else _randn(dev, b, sk, c, dtype=dtype, seed=2)
    w = [_randn(dev, c, c, dtype=dtype, scale=c ** -0.5, seed=3 + i)
         for i in range(4)]
    bs = [_randn(dev, c, dtype=dtype, scale=0.1, seed=9 + i)
          for i in range(4)]
    qkv = bs[:3] if biases else [None] * 3
    before = fa.attention_block.launches
    out = fa.attention_block(x, ctx, *w, bs[3], heads, *qkv)
    torch.cuda.synchronize()
    assert fa.attention_block.launches == before + 1
    f = [None if t is None else t.float() for t in (x, ctx, *w, bs[3])]
    ref = fa.attention_block_plain(*f, heads,
                                   *[None if t is None else t.float()
                                     for t in qkv])
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(2, 512, 64, 64), (3, 24, 7, 5),
                                   (1, 130, 33, 1)])
@pytest.mark.parametrize('channels_last', [False, True])
def test_spatial_sums_matches_plain(dev, dtype, shape, channels_last):
    x = _randn(dev, *shape, dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    before = gs.spatial_sums.launches
    s1, s2 = gs.spatial_sums(x)
    torch.cuda.synchronize()
    assert gs.spatial_sums.launches == before + 1
    r1, r2 = gs.spatial_sums_plain(x)
    mag = x.float().abs().sum(dim=(2, 3))
    assert ((s1 - r1).abs() / mag).max().item() <= 1e-4
    assert ((s2 - r2).abs() / r2).max().item() <= 1e-4


def test_kernels_raise_on_what_they_cannot_take(dev):
    q = torch.zeros(1, 8, 1, 520, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head dim'):
        fa.attn_fwd(q, q, q)
    h = torch.zeros(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.attn_fwd(h, h, h)
    x = torch.zeros(1, 4, 8, 8, device=dev)[:, :, :, :4]
    with pytest.raises(ValueError, match='flattenable'):
        gs.spatial_sums(x)


def test_tiny_pipeline_card_matches_cpu(dev):
    """fp32 tiny pipeline at 256x256 (32x32 latents: 1024-key
    self-attention takes K1, the VAE mid-block K3): card vs CPU."""
    exact_fp32()
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    cfg, table = init_concepts(b.tokenizer, '<c1>', None,
                               b.text_encoder.token_embedding.weight)
    kw = dict(dtype=torch.float32, new_concept_cfg=cfg,
              concept_embedding=table)
    gpu = EDLoRAPipeline(*copy.deepcopy((b.unet, b.text_encoder, b.vae)),
                         b.tokenizer, dev, **kw)
    cpu = EDLoRAPipeline(b.unet, b.text_encoder, b.vae, b.tokenizer, 'cpu',
                         **kw)
    lat = torch.randn(1, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    args = dict(prompt='a photo of <c1>', height=256, width=256,
                num_inference_steps=2, latents=lat, output_type='np')
    ops.reset_launch_counts()
    img = gpu(**args)
    counts = ops.launch_counts()
    # the plain path runs K1, K2 and K3; K7 belongs to the regional path
    assert all(counts[k] > 0 for k in ('attn_fwd', 'gn_spatial_sums',
                                       'attn_block'))
    assert counts['region_attn'] == 0
    np.testing.assert_allclose(img, cpu(**args), atol=2e-3)


THREE_BOXES = [[0.02, 0.05, 0.95, 0.30], [0.02, 0.35, 0.95, 0.62],
               [0.02, 0.68, 0.95, 0.97]]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,h,w,heads,d,sk,boxes', [
    (4, 64, 64, 8, 40, 77, THREE_BOXES),       # the SD1.5 layers at 512²
    (4, 32, 32, 8, 80, 77, THREE_BOXES),
    (4, 16, 16, 8, 160, 77, THREE_BOXES),
    (4, 8, 8, 8, 160, 77, THREE_BOXES),
    (2, 12, 20, 2, 24, 77, [[0.0, 0.0, 1.0, 0.5], [0.25, 0.25, 0.875, 1.0],
                            [0.1, 0.2, 0.9, 0.8]]),   # ragged, overlapping
    (1, 9, 7, 3, 64, 100, [[0.5, 0.5, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0]]),
    (2, 8, 16, 1, 16, 5, [[0.3, 0.0, 0.7, 0.6]])])
def test_region_attention_matches_plain(dev, dtype, b, h, w, heads, d, sk,
                                        boxes):
    q = _randn(dev, b, h * w, heads, d, dtype=dtype, seed=1)
    gk, gv = (_randn(dev, b, sk, heads, d, dtype=dtype, seed=s)
              for s in (2, 3))
    rk, rv = (_randn(dev, len(boxes), b, sk, heads, d, dtype=dtype, seed=s)
              for s in (4, 5))
    px = ra.boxes_to_grid(boxes, h, w)
    before = ra.region_attention.launches
    out = ra.region_attention(q, gk, gv, rk, rv, px, (h, w))
    torch.cuda.synchronize()
    assert ra.region_attention.launches == before + 1
    ref = ra.region_attention_plain(q.float(), gk.float(), gv.float(),
                                    rk.float(), rv.float(), px, (h, w))
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=0)


def test_region_attention_raises_on_what_it_cannot_take(dev):
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=dev, dtype=dtype)
    q, kv, rkv = t(1, 16, 2, 16), t(1, 77, 2, 16), t(1, 1, 77, 2, 16)
    box = [[0, 0, 2, 2]]
    with pytest.raises(ValueError, match='head dim'):
        ra.region_attention(t(1, 16, 1, 168), t(1, 77, 1, 168),
                            t(1, 77, 1, 168), t(1, 1, 77, 1, 168),
                            t(1, 1, 77, 1, 168), box, (4, 4))
    with pytest.raises(ValueError, match='regions'):
        ra.region_attention(q, kv, kv, rkv.expand(17, -1, -1, -1, -1)
                            .contiguous(), rkv.expand(17, -1, -1, -1, -1)
                            .contiguous(), box * 17, (4, 4))
    with pytest.raises(ValueError, match='shape mismatch'):
        ra.region_attention(q, kv, kv, rkv, rkv, box, (4, 5))
    with pytest.raises(ValueError, match='contiguous'):
        ra.region_attention(t(1, 2, 16, 16).transpose(1, 2), kv, kv, rkv,
                            rkv, box, (4, 4))
    with pytest.raises(TypeError):
        ra.region_attention(q.half(), kv, kv, rkv, rkv, box, (4, 4))
    with pytest.raises(ValueError, match='one device'):
        ra.region_attention(q, kv.cpu(), kv, rkv, rkv, box, (4, 4))


def test_tiny_regional_pipeline_card_matches_cpu(dev):
    """fp32 tiny regional pipeline at 256x256 with 2 regions and a keypose
    adapter: card vs CPU, with all four kernels launched."""
    exact_fp32()
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    cfg, table = init_concepts(b.tokenizer, '<c1>+<c2>', None,
                               b.text_encoder.token_embedding.weight)
    adapter = zoo.load_t2i_adapter('keypose', 'tiny', 'cpu', seed=3)
    mods = (b.unet, b.text_encoder, b.vae, adapter)
    kw = dict(dtype=torch.float32, new_concept_cfg=cfg,
              concept_embedding=table)
    gpu_mods = copy.deepcopy(mods)
    gpu = RegionallyT2IAdapterPipeline(*gpu_mods[:3], b.tokenizer, dev,
                                       keypose_adapter=gpu_mods[3], **kw)
    cpu = RegionallyT2IAdapterPipeline(*mods[:3], b.tokenizer, 'cpu',
                                       keypose_adapter=mods[3], **kw)
    pose = np.zeros((256, 256, 3), np.float32)
    pose[64:192, 96:160] = 1.0
    layout = [('two friends', [('a <c1>', 'blurry', [0.0, 0.0, 1.0, 0.6]),
                               ('a <c2>', '', [0.2, 0.4, 0.9, 1.0])])]
    lat = torch.randn(1, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    args = dict(keypose_adapter_input=pose, height=256, width=256,
                num_inference_steps=2, latents=lat, output_type='np')
    ops.reset_launch_counts()
    img = gpu(layout, **args)
    assert all(n > 0 for n in ops.launch_counts().values())
    np.testing.assert_allclose(img, cpu(layout, **args), atol=2e-3)
