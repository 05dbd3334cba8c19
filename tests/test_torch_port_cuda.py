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
from mixofshow_tpu_torch.pipelines import EDLoRAPipeline, init_concepts
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
    assert all(n > 0 for n in ops.launch_counts().values())
    np.testing.assert_allclose(img, cpu(**args), atol=2e-3)
