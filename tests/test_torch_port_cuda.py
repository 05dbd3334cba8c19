"""The port's kernels on the card, against their plain PyTorch versions.

These need an NVIDIA GPU (Hopper, sm_90a) with nvcc and triton, and skip
elsewhere. This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: bf16 kernels against the fp32 plain version on the same bf16
inputs 3e-2 (P and the output round to bf16); K1 in bf16 1e-2 of its bf16
twin's largest entry (see ATTN_BF16_REL), the bf16 flash kernels 2e-2 of it
(see FLASH_BF16_REL); fp32 kernels 1e-5 (the flash kernels 1e-4: their
sums run over up to 2048 keys in another order); fp32 sums relative 1e-4
of the sum of magnitudes.
"""
import copy

import numpy as np
import pytest
import torch

from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree
from mixofshow_tpu_torch.ops import flash_attention as fl
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


def twin_err(got, want):
    """Largest error of a kernel's output against its twin: relative to
    the twin's largest entry in bf16, absolute in fp32."""
    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.bfloat16:
        return err / want.float().abs().max().item()
    return err


# K1 in bf16 against its twin on the same inputs (q̃ = bf16(q·scale) and the
# output rounded to bf16 in both): the two round fp32 values that agree to
# ~1e-4, so they differ by at most one bf16 ulp, 2^-7 of max|twin|
ATTN_BF16_REL = 1e-2
ATTN_TOL = {torch.bfloat16: ATTN_BF16_REL, torch.float32: TOL[torch.float32]}


def k1_faults(q, k, v, kv_len):
    """Planted K1 faults the bound must reject: the twin without keys
    64-127 (one 64-key tile) and, for a ragged kv_len, without the ragged
    last tile and without the kv_len mask."""
    def drop(t):
        return torch.cat((t[:, :64], t[:, 128:]), dim=1)
    faults = [fa.attn_fwd_plain(q, drop(k), drop(v),
                                64 + max(kv_len - 128, 0))]
    if kv_len % 64:
        faults.append(fa.attn_fwd_plain(q, k, v, kv_len // 64 * 64))
    if kv_len < k.shape[1]:
        faults.append(fa.attn_fwd_plain(q, k, v))
    return faults


# K1's shapes: every bf16 head-width tile (D 16 to 160, and 512 on the wide
# core), Sq and kv_len off the 64-key and the 128- and 256-query tiles,
# batch 1, and grids on both sides of the two/four-warpgroup rule (four
# from 99 blocks of 256 queries on 132 SMs, up to D 80)
ATTN_CASES = [(2, 100, 130, 2, 16, 77), (1, 256, 256, 2, 40, 256),
              (2, 1024, 1024, 8, 80, 1024), (1, 64, 77, 3, 24, 77),
              (1, 200, 200, 2, 160, 199), (1, 300, 300, 1, 512, 290),
              (1, 70, 90, 2, 100, 90), (1, 333, 1030, 2, 24, 1001),
              (1, 130, 300, 3, 100, 257), (1, 1000, 1100, 4, 80, 1037),
              (2, 2200, 1500, 8, 40, 1433), (1, 4160, 700, 8, 16, 650),
              (2, 1100, 600, 16, 160, 555), (1, 2100, 500, 16, 100, 480),
              (4, 1100, 1100, 8, 80, 1037), (2, 1300, 900, 16, 24, 877),
              (1, 2000, 700, 16, 64, 650)]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,h,d,kv_len', ATTN_CASES)
def test_attn_fwd_matches_plain(dev, dtype, b, sq, sk, h, d, kv_len):
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=1)
    k = _randn(dev, b, sk, h, d, dtype=dtype, seed=2)
    v = _randn(dev, b, sk, h, d, dtype=dtype, seed=3)
    before = fa.attn_fwd.launches
    out = fa.attn_fwd(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert fa.attn_fwd.launches == before + 1
    ref = fa.attn_fwd_plain(q, k, v, kv_len)
    assert out.dtype == dtype and out.shape == q.shape
    assert twin_err(out, ref) <= ATTN_TOL[dtype]
    for bad in k1_faults(q, k, v, kv_len):
        assert twin_err(bad, ref) > ATTN_TOL[dtype]


@pytest.mark.parametrize('b,sq,h,d', [(4, 4096, 8, 40), (4, 1024, 8, 80),
                                      (1, 1000, 2, 160)])
def test_attn_fwd_reruns_bit_identical(dev, b, sq, h, d):
    q, k, v = (_randn(dev, b, sq, h, d, dtype=torch.bfloat16, seed=s)
               for s in (1, 2, 3))
    first = fa.attn_fwd(q, k, v)
    assert torch.equal(fa.attn_fwd(q, k, v), first)


def test_attn_fwd_reads_strided_views(dev):
    """q/k/v as column slices of one fused (B, S, 3C) tensor."""
    qkv = _randn(dev, 2, 300, 3 * 64, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 300, 2, 32) for t in qkv.split(64, dim=-1))
    assert twin_err(fa.attn_fwd(q, k, v), fa.attn_fwd_plain(q, k, v)) \
        <= ATTN_BF16_REL


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,c,heads,biases', [
    (2, 1024, 1024, 512, 1, True), (1, 100, 77, 64, 2, False),
    (2, 300, 300, 32, 1, True), (2, 256, 77, 512, 1, True),
    (1, 300, 300, 512, 1, True), (2, 4096, 4096, 512, 1, True)])
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
    # the plain path runs K1, K2 and K3; K7 belongs to the regional path,
    # K4-K6 to training
    assert all(counts[k] > 0 for k in ('attn_fwd', 'gn_spatial_sums',
                                       'attn_block'))
    assert all(counts[k] == 0 for k in ('region_attn', 'flash_fwd',
                                        'flash_bwd_dkv', 'flash_bwd_dq'))
    np.testing.assert_allclose(img, cpu(**args), atol=2e-3)


THREE_BOXES = [[0.02, 0.05, 0.95, 0.30], [0.02, 0.35, 0.95, 0.62],
               [0.02, 0.68, 0.95, 0.97]]
# three overlapping boxes, two on the grid's edges
OVERLAP_BOXES = [[0.0, 0.0, 0.6, 0.6], [0.3, 0.3, 0.9, 0.9],
                 [0.2, 0.5, 1.0, 1.0]]

# K7 in bf16 against its bf16 twin (fp32 math on the same bf16 inputs, the
# output rounded to bf16): the kernel also rounds P to bf16 for P·V, so the
# two differ by about one bf16 ulp of the output, at most 2^-7 of
# max|twin|; the planted faults (k7_faults) must come out over it
REGION_BF16_REL = 1e-2
REGION_TOL = {torch.bfloat16: REGION_BF16_REL,
              torch.float32: TOL[torch.float32]}


def k7_faults(q, gk, gv, rk, rv, px, hw):
    """Planted K7 faults the bound must reject, on the twin: the largest
    box's context left out, the global context attended inside that box,
    the box moved down one pixel row and, where boxes overlap, the sum
    over the boxes in place of their mean (none when no box covers a
    pixel)."""
    h, w = hw
    px = np.asarray(px).reshape(-1, 4)
    masks = [ra.box_mask(box, h, w, q.device) for box in px]
    sizes = [float(m.sum()) for m in masks]
    if not any(sizes):
        return []
    big = int(np.argmax(sizes))
    keep = [i for i in range(len(px)) if i != big]
    plain = ra.region_attention_plain
    rk_g, rv_g = rk.clone(), rv.clone()
    rk_g[big], rv_g[big] = gk, gv
    moved = px.copy()
    moved[big] += np.asarray([1, 0, 1, 0], moved.dtype)
    faults = [plain(q, gk, gv, rk[keep], rv[keep], px[keep], hw),
              plain(q, gk, gv, rk_g, rv_g, px, hw),
              plain(q, gk, gv, rk, rv, moved, hw)]
    cnt = sum(masks).reshape(1, -1, 1, 1)
    if cnt.max() > 1:
        ref = plain(q, gk, gv, rk, rv, px, hw)
        faults.append((ref.float() * torch.clamp(cnt, min=1)).to(ref.dtype))
    return faults


# K7's shapes: the SD1.5 regional layers at 512² (2 images x CFG) with the
# three boxes and with three overlapping ones; every bf16 head width (D 16
# to 160: 16, 32, 48, 64, 80, 128 and 160 wide tiles), 77 and 128 keys (80
# and 128 key tiles) and 5; 1 and 16 regions; boxes on the grid's edges,
# overlapping and one that covers no pixel; grids off the 16-pixel tile
# (tiles of 16, 8, 4 and 2 rows) and off every run of tiles a block takes;
# every branch of the block rule (launch_runs in csrc/region_attn.cu)
REGION_CASES = [
    (4, 64, 64, 8, 40, 77, THREE_BOXES),
    (4, 32, 32, 8, 80, 77, THREE_BOXES),
    (4, 16, 16, 8, 160, 77, THREE_BOXES),
    (4, 8, 8, 8, 160, 77, THREE_BOXES),
    (4, 64, 64, 8, 40, 77, OVERLAP_BOXES),
    (2, 12, 20, 2, 24, 77, [[0.0, 0.0, 1.0, 0.5], [0.25, 0.25, 0.875, 1.0],
                            [0.1, 0.2, 0.9, 0.8]]),   # ragged, overlapping
    (1, 9, 7, 3, 64, 100, [[0.5, 0.5, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0]]),
    (2, 8, 16, 1, 16, 5, [[0.3, 0.0, 0.7, 0.6]]),
    (2, 33, 31, 4, 100, 128, OVERLAP_BOXES),
    (2, 40, 48, 8, 128, 128, [[0.0, 0.0, 1.0, 1.0]]),
    (2, 17, 45, 3, 80, 5, np.random.default_rng(3).uniform(
        0, 1, (16, 4)).round(2).tolist()),
    (1, 26, 26, 16, 160, 128, OVERLAP_BOXES),
    (2, 48, 48, 8, 48, 77, THREE_BOXES),
    (3, 40, 40, 8, 40, 77, [[0.1, 0.0, 0.4, 1.0]]),
    (1, 5, 30, 2, 64, 77, [[0.2, 0.1, 0.8, 0.5], [0.0, 0.4, 1.0, 1.0]]),
    (2, 3, 50, 2, 40, 77, [[0.0, 0.3, 0.7, 0.9]])]


def _region_inputs(dev, dtype, b, h, w, heads, d, sk, boxes):
    q = _randn(dev, b, h * w, heads, d, dtype=dtype, seed=1)
    gk, gv = (_randn(dev, b, sk, heads, d, dtype=dtype, seed=s)
              for s in (2, 3))
    rk, rv = (_randn(dev, len(boxes), b, sk, heads, d, dtype=dtype, seed=s)
              for s in (4, 5))
    return q, gk, gv, rk, rv, ra.boxes_to_grid(boxes, h, w), (h, w)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,h,w,heads,d,sk,boxes', REGION_CASES)
def test_region_attention_matches_plain(dev, dtype, b, h, w, heads, d, sk,
                                        boxes):
    """K7 against its twin on the same inputs: bf16 within REGION_BF16_REL
    of max|twin|, with every planted fault over it; fp32 absolute."""
    args = _region_inputs(dev, dtype, b, h, w, heads, d, sk, boxes)
    q = args[0]
    before = ra.region_attention.launches
    out = ra.region_attention(*args)
    torch.cuda.synchronize()
    assert ra.region_attention.launches == before + 1
    ref = ra.region_attention_plain(*args)
    assert out.dtype == dtype and out.shape == q.shape
    assert twin_err(out, ref) <= REGION_TOL[dtype]
    if dtype == torch.bfloat16:
        for bad in k7_faults(*args):
            assert twin_err(bad, ref) > REGION_BF16_REL


@pytest.mark.parametrize('b,h,w,heads,d,sk,boxes', [
    REGION_CASES[0], REGION_CASES[3], REGION_CASES[4], REGION_CASES[10]])
def test_region_attention_reruns_bit_identical(dev, b, h, w, heads, d, sk,
                                               boxes):
    args = _region_inputs(dev, torch.bfloat16, b, h, w, heads, d, sk, boxes)
    first = ra.region_attention(*args)
    assert torch.equal(ra.region_attention(*args), first)


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
    counts = ops.launch_counts()
    # the four sampling kernels launch; the training path's flash kernels
    # do not
    assert all(counts[k] > 0 for k in ('attn_fwd', 'gn_spatial_sums',
                                       'attn_block', 'region_attn'))
    assert all(counts[k] == 0 for k in ('flash_fwd', 'flash_bwd_dkv',
                                        'flash_bwd_dq'))
    np.testing.assert_allclose(img, cpu(layout, **args), atol=2e-3)


# The flash kernels in bf16: the largest error relative to the twin's
# largest entry (one bf16 ulp there is 2^-8 to 2^-7 of it; a twin that keeps
# P and dS in fp32 stays within 6.2e-3 of it at FLASH_CASES, a backward that
# drops Dvec from dS is 3.5e-2 or more off), and the fp32 LSE absolute. In
# fp32 all absolute: sums over up to 2048 keys in another order.
FLASH_BF16_REL = 2e-2
FLASH_LSE_TOL = 1e-3
FLASH_F32_TOL = 1e-4
FLASH_CASES = [(1, 256, 1024, 2, 16), (2, 130, 1100, 2, 40),
               (1, 1024, 1024, 8, 80), (1, 200, 1300, 2, 160),
               (1, 128, 2048, 1, 96), (1, 300, 1024, 3, 64),
               (1, 1000, 777, 2, 40), (2, 333, 1100, 1, 80),
               (1, 77, 300, 2, 160), (1, 130, 70, 3, 16),
               (1, 190, 1030, 2, 24), (1, 129, 1025, 2, 100),
               (2, 1100, 1300, 16, 40), (1, 2100, 700, 16, 160),
               (2, 770, 1100, 16, 80)]


def flash_bound(dtype):
    return FLASH_BF16_REL if dtype == torch.bfloat16 else FLASH_F32_TOL


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,sq,sk,h,d', FLASH_CASES)
def test_flash_kernels_match_twins(dev, dtype, b, sq, sk, h, d):
    """K4 (o and lse), K5 (dk, dv) and K6 (dq) against the twins on the same
    inputs, ragged Sq/Sk and every head-width tile included; the bound
    rejects a planted fault, the twin's backward without Dvec."""
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=1)
    k = _randn(dev, b, sk, h, d, dtype=dtype, seed=2)
    v = _randn(dev, b, sk, h, d, dtype=dtype, seed=3)
    do = _randn(dev, b, sq, h, d, dtype=dtype, seed=4)
    before = ops.launch_counts()
    o, lse = fl.flash_fwd(q, k, v)
    dvec = fl.flash_dvec(do, o)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, dvec)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert all(after[n] == before[n] + 1 for n in
               ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq'))
    ro, rlse = fl.flash_fwd_plain(q, k, v)
    bound = flash_bound(dtype)
    assert o.dtype == dtype and lse.shape == (b, h, sq)
    assert twin_err(o, ro) <= bound
    torch.testing.assert_close(
        lse, rlse, rtol=0,
        atol=FLASH_LSE_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL)
    want = fl.flash_bwd_plain(q, k, v, do, lse, dvec)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype
        assert twin_err(got, ref) <= bound
    bad = fl.flash_bwd_plain(q, k, v, do, lse, torch.zeros_like(dvec))
    assert twin_err(bad[0], want[0]) > bound
    assert twin_err(bad[1], want[1]) > bound


# K6's shapes: every bf16 head-width tile (D 16 to 160: 16, 32, 48, 64, 80,
# 96, 128 and 160 wide), Sq and Sk off the 64-key tile and the query block
# (1000 x 1100 among them), Sq below one 64-query tile, Sk below one key
# tile, the training path's two shapes, and grids of 16 to 512 blocks
DQ_CASES = [(2, 1000, 1100, 8, 40), (1, 50, 1030, 2, 16),
            (1, 77, 300, 2, 24), (2, 300, 200, 3, 64), (1, 513, 1024, 4, 80),
            (1, 130, 40, 2, 96), (1, 250, 700, 2, 100), (1, 64, 64, 1, 128),
            (2, 190, 1100, 2, 160), (2, 4096, 4096, 8, 40),
            (2, 1024, 1024, 8, 80), (1, 2100, 700, 16, 160)]


@pytest.mark.parametrize('b,sq,sk,h,d', DQ_CASES)
def test_flash_bwd_dq_matches_twin(dev, b, sq, sk, h, d):
    """K6 in bf16 against its twin within FLASH_BF16_REL of max|twin|, the
    planted fault (the twin without Dvec) over it, and a rerun
    bit-identical."""
    q, do = (_randn(dev, b, sq, h, d, dtype=torch.bfloat16, seed=s)
             for s in (1, 4))
    k, v = (_randn(dev, b, sk, h, d, dtype=torch.bfloat16, seed=s)
            for s in (2, 3))
    o, lse = fl.flash_fwd(q, k, v)
    dvec = fl.flash_dvec(do, o)
    before = fl.flash_bwd_dq.launches
    dq = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
    torch.cuda.synchronize()
    assert fl.flash_bwd_dq.launches == before + 1
    want = fl.flash_bwd_dq_plain(q, k, v, do, lse, dvec)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert twin_err(dq, want) <= FLASH_BF16_REL
    bad = fl.flash_bwd_dq_plain(q, k, v, do, lse, torch.zeros_like(dvec))
    assert twin_err(bad, want) > FLASH_BF16_REL
    assert torch.equal(fl.flash_bwd_dq(q, k, v, do, lse, dvec), dq)


def test_flash_fp32_backward_matches_autograd_of_plain(dev):
    q, k, v, do = (_randn(dev, 2, n, 2, 40, dtype=torch.float32, seed=s)
                   for n, s in ((500, 1), (1030, 2), (1030, 3), (500, 4)))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    fl.flash_attention(*ts).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.attn_fwd_plain(*ref).backward(do)
    for a, b_ in zip(ts, ref):
        torch.testing.assert_close(a.grad, b_.grad, atol=1e-4, rtol=0)


def test_flash_strided_grad_and_bitwise_reruns(dev):
    """A dO that reaches the Function transposed (non-contiguous) is taken;
    two backward passes give bit-identical gradients (no atomics)."""
    q, k, v = (_randn(dev, 2, 1024, 4, 40, dtype=torch.bfloat16, seed=s)
               for s in (1, 2, 3))
    w = _randn(dev, 2, 4, 1024, 40, dtype=torch.bfloat16, seed=4)
    grads = []
    for _ in range(2):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (fl.flash_attention(*ts).transpose(1, 2) * w).float().sum() \
            .backward()
        grads.append([t.grad for t in ts])
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
    o, lse = fl.flash_fwd(q, k, v)
    do = w.transpose(1, 2).contiguous()
    want = fl.flash_bwd_plain(q, k, v, do, lse, fl.flash_dvec(do, o))
    for a, b_ in zip(grads[0], want):
        assert twin_err(a, b_) <= FLASH_BF16_REL


def test_flash_raises_on_what_it_cannot_take(dev):
    t = torch.zeros(1, 128, 1, 168, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head dim'):
        fl.flash_fwd(t, t, t)
    h = torch.zeros(1, 128, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fl.flash_fwd(h, h, h)
    q = torch.zeros(1, 128, 2, 16, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 130, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='shape mismatch'):
        fl.flash_fwd(q, k, k)
    lse = torch.zeros(1, 2, 128, device=dev)
    with pytest.raises(ValueError, match='contiguous'):
        fl.flash_bwd_dq(q, q, q, q.transpose(1, 2).contiguous()
                        .transpose(1, 2), lse, lse)


def test_unet_gradient_reaches_every_attn1_lora_on_the_card(dev):
    """fp32 tiny UNet at 32x32 latents on the card (the res-32
    self-attentions take K4-K6, none takes K1): every attn1 LoRA leaf gets a
    finite non-zero gradient, equal to the CPU's within 1e-3 of the largest
    entry."""
    exact_fp32()
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    unet_cpu = b.unet.requires_grad_(False)
    unet_gpu = copy.deepcopy(unet_cpu).to(dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 32, 32)).astype(np.float32))
    ehs = torch.from_numpy(rng.normal(size=(2, 77, 64)).astype(np.float32))
    grads = []
    for unet, d in ((unet_gpu, dev), (unet_cpu, 'cpu')):
        lora = init_lora_tree(np.random.default_rng(1), unet,
                              lambda p: '/attn1/' in p or '/attn2/' in p,
                              rank=4, device=d)
        for leaf in flatten_lora(lora).values():
            leaf['up'].fill_(0.01)
            for t in leaf.values():
                t.requires_grad_()
        ops.reset_launch_counts()
        out = unet(x.to(d), torch.tensor([300, 700], device=d), ehs.to(d),
                   lora, 1.0)
        out.square().mean().backward()
        if d == dev:
            counts = ops.launch_counts()
        grads.append({p: [leaf[n].grad.cpu() for n in ('down', 'up')]
                      for p, leaf in flatten_lora(lora).items()})
    assert counts['flash_fwd'] == counts['flash_bwd_dkv'] == \
        counts['flash_bwd_dq'] == 5 and counts['attn_fwd'] == 0
    attn1 = [p for p in grads[0] if '/attn1/' in p]
    assert len(attn1) == 64
    scale = max(g.abs().max().item() for gs_ in grads[1].values()
                for g in gs_)
    for p in attn1:
        for g, c in zip(grads[0][p], grads[1][p]):
            assert torch.isfinite(g).all() and g.abs().max() > 0, p
            assert (g - c).abs().max().item() <= 1e-3 * scale, p


# bf16: one bf16 ulp at the top binade of the twin (2^-7 of max|twin|; both
# round x·a and + b to bf16, the SiLU's fp32 exp may differ by an ulp).
# fp32: 1e-6 of max|twin| (an FMA and the SiLU's exp in another order)
APPLY_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-6}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('act', ['none', 'silu'])
@pytest.mark.parametrize('shape,channels_last', [
    ((2, 512, 64, 64), False), ((3, 24, 7, 5), False),
    ((1, 130, 33, 1), False), ((2, 32, 9, 10), True)])
def test_scale_bias_act_matches_plain(dev, dtype, act, shape,
                                      channels_last):
    x = _randn(dev, *shape, dtype=dtype, seed=1)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    a = _randn(dev, *shape[:2], dtype=torch.float32, seed=2) * 0.2 + 1.0
    b = _randn(dev, *shape[:2], dtype=torch.float32, seed=3) * 0.2
    before = gs.scale_bias_act.launches
    out = gs.scale_bias_act(x, a, b, act)
    torch.cuda.synchronize()
    assert gs.scale_bias_act.launches == before + 1
    ref = gs.scale_bias_act_plain(x, a, b, act)
    assert out.dtype == dtype and out.stride() == x.stride()
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= APPLY_TOL[dtype]


def test_scale_bias_act_backward_matches_autograd_of_plain(dev):
    """fp32: the kernel's forward with the plain backward against autograd
    of the plain version."""
    x = _randn(dev, 2, 64, 16, 16, dtype=torch.float32, seed=4)
    a = (_randn(dev, 2, 64, dtype=torch.float32, seed=5) * 0.2 + 1.0)
    b = _randn(dev, 2, 64, dtype=torch.float32, seed=6) * 0.2
    w = _randn(dev, 2, 64, 16, 16, dtype=torch.float32, seed=7)
    grads = []
    for fn in (gs.scale_bias_act, gs.scale_bias_act_plain):
        ts = [t.clone().requires_grad_() for t in (x, a, b)]
        (fn(*ts, 'silu') * w).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_vae_decode_launches_k8_per_group_norm(dev):
    b = zoo.load_models('random:tiny', dev, seed=0)
    norms = sum(isinstance(m, torch.nn.GroupNorm)
                for m in b.vae.decoder.modules())
    ops.reset_launch_counts()
    with torch.no_grad():
        b.vae.decode(_randn(dev, 1, 4, 8, 8, dtype=torch.float32))
    counts = ops.launch_counts()
    assert counts['gn_apply'] == counts['gn_spatial_sums'] == norms


# The validation sweeps' shapes: 4 prompts a batch (batch_size_per_gpu of
# the shipped configs' val_vis), so the UNet runs at batch 8 with CFG and
# the VAE decodes 4 images at its six GroupNorm shapes
VAL_DECODE_SHAPES = [(4, 512, 64, 64), (4, 512, 128, 128),
                     (4, 512, 256, 256), (4, 256, 256, 256),
                     (4, 256, 512, 512), (4, 128, 512, 512)]


@pytest.mark.parametrize('b,s,h,d', [(8, 4096, 8, 40), (8, 1024, 8, 80)])
def test_attn_fwd_at_the_validation_batch(dev, b, s, h, d):
    q, k, v = (_randn(dev, b, s, h, d, dtype=torch.bfloat16, seed=i)
               for i in (1, 2, 3))
    out = fa.attn_fwd(q, k, v)
    ref = fa.attn_fwd_plain(q, k, v)
    assert twin_err(out, ref) <= ATTN_BF16_REL
    for bad in k1_faults(q, k, v, s):
        assert twin_err(bad, ref) > ATTN_BF16_REL


def test_attention_block_at_the_validation_batch(dev):
    c = 512
    x = _randn(dev, 4, 4096, c, dtype=torch.bfloat16, seed=1)
    w = [_randn(dev, c, c, dtype=torch.bfloat16, scale=c ** -0.5, seed=3 + i)
         for i in range(4)]
    bs = [_randn(dev, c, dtype=torch.bfloat16, scale=0.1, seed=9 + i)
          for i in range(4)]
    out = fa.attention_block(x, x, *w, bs[3], 1, *bs[:3])
    ref = fa.attention_block_plain(*(t.float() for t in (x, x, *w, bs[3])),
                                   1, *(t.float() for t in bs[:3]))
    torch.testing.assert_close(out.float(), ref, atol=TOL[torch.bfloat16],
                               rtol=0)


@pytest.mark.parametrize('shape', VAL_DECODE_SHAPES)
def test_spatial_sums_at_the_validation_batch(dev, shape):
    x = _randn(dev, *shape, dtype=torch.bfloat16)
    s1, s2 = gs.spatial_sums(x)
    r1, r2 = gs.spatial_sums_plain(x)
    mag = x.float().abs().sum(dim=(2, 3))
    assert ((s1 - r1).abs() / mag).max().item() <= 1e-4
    assert ((s2 - r2).abs() / r2).max().item() <= 1e-4


@pytest.mark.parametrize('shape,act', [(VAL_DECODE_SHAPES[0], 'none')] +
                         [(s, 'silu') for s in VAL_DECODE_SHAPES])
def test_scale_bias_act_at_the_validation_batch(dev, shape, act):
    x = _randn(dev, *shape, dtype=torch.bfloat16, seed=1)
    a = _randn(dev, *shape[:2], dtype=torch.float32, seed=2) * 0.2 + 1.0
    b = _randn(dev, *shape[:2], dtype=torch.float32, seed=3) * 0.2
    out = gs.scale_bias_act(x, a, b, act)
    ref = gs.scale_bias_act_plain(x, a, b, act)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= APPLY_TOL[torch.bfloat16]


# The regional CLI's wide canvases: 512x1024 (2 images x CFG) with the
# real_pose layout's three boxes, normalized as the CLI normalizes them,
# at the 64x128 and 8x16 grids; regionally_sample.sh's two boxes, which
# end at pixel 1024 of a 512-high canvas (2.0, past the lower edge); and
# K1 at the 1024x2048 canvas's res-64 layer
WIDE_BOXES = [[4 / 512, 28 / 1024, 508 / 512, 251 / 1024],
              [4 / 512, 215 / 1024, 508 / 512, 453 / 1024],
              [4 / 512, 651 / 1024, 508 / 512, 996 / 1024]]
PAST_EDGE_BOXES = [[12 / 512, 36 / 1024, 2.0, 600 / 1024],
                   [18 / 512, 696 / 1024, 2.0, 1180 / 1024]]


@pytest.mark.parametrize('b,h,w,heads,d,sk,boxes', [
    (4, 64, 128, 8, 40, 77, WIDE_BOXES),
    (4, 8, 16, 8, 160, 77, WIDE_BOXES),
    (2, 64, 128, 8, 40, 77, PAST_EDGE_BOXES),
    (2, 16, 32, 8, 160, 77, PAST_EDGE_BOXES)])
def test_region_attention_on_wide_grids(dev, b, h, w, heads, d, sk, boxes):
    args = _region_inputs(dev, torch.bfloat16, b, h, w, heads, d, sk, boxes)
    px = args[5]
    assert (px[:, 2] > h).any() == (boxes is PAST_EDGE_BOXES)
    out = ra.region_attention(*args)
    ref = ra.region_attention_plain(*args)
    assert twin_err(out, ref) <= REGION_BF16_REL
    for bad in k7_faults(*args):
        assert twin_err(bad, ref) > REGION_BF16_REL
    assert torch.equal(ra.region_attention(*args), out)


def test_attn_fwd_at_the_wide_canvas(dev):
    q, k, v = (_randn(dev, 2, 8192, 8, 80, dtype=torch.bfloat16, seed=i)
               for i in (1, 2, 3))
    out = fa.attn_fwd(q, k, v)
    ref = fa.attn_fwd_plain(q, k, v)
    assert twin_err(out, ref) <= ATTN_BF16_REL
    for bad in k1_faults(q, k, v, 8192):
        assert twin_err(bad, ref) > ATTN_BF16_REL
