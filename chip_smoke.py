#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mixofshow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero without a result
line when any fails, or when no CUDA device is visible):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc-builds the CUDA kernels from csrc/ into .torch_ext/ (one
                process per source, in parallel) and JIT-compiles the Triton
                kernel, timing each;
  3. kernels  — each kernel against its plain PyTorch version on the same
                inputs at the main paths' shapes, error against a stated
                bound, and both times from CUDA events;
  4. wiring   — the tiny config in fp32 (TF32 off) at 512x512, 2 steps, on
                the card and on the CPU, images compared: EDLoRAPipeline
                (K1, K2, K3 launch) and RegionallyT2IAdapterPipeline with 2
                regions and a keypose adapter (all four launch);
  5. main     — ED-LoRA path: SD1.5-width UNet, CLIP and VAE in bf16,
                random weights from a seeded generator on the card, two
                concept tokens; two requests of 2 prompts at 512x512, CFG
                7.5, 50 DPM-Solver++ steps, one through __call__ and one
                through submit().result(), uint8 output. Checks shapes, that
                the images are not constant and identical across the two
                requests (same latents), and that K1, K2 and K3 launched;
  6. regional — regional path: the same widths plus a full-width keypose
                adapter, three concepts in three boxes (bench.py's layout),
                the repository's keypose image, 2 images at 512x512, CFG
                7.5, 50 steps, one request through __call__ and one through
                submit().result(). Checks as in 5, and that every request
                launched K7 16 x 50 times and K1, K2, K3 too.
Then one JSON line with the kernels (launches: phases 5 and 6 together),
the nvidia-smi line, and the last line {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import fused_attention as fa
from mixofshow_tpu_torch.ops import gn_stats as gs
from mixofshow_tpu_torch.ops import region_attention as ra
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline,
                                           init_concepts)
from mixofshow_tpu_torch.utils.device import exact_fp32, require_cuda

# bf16 kernels against the fp32 plain version on the same bf16 inputs:
# P and the output are rounded to bf16 (2^-8 relative), so a few 1e-3 is
# expected; 3e-2 is the bound the JAX suite uses for its bf16 attention
# kernels (tests/test_ops.py).
ATTN_BOUND = 3e-2
# fp32 sums over up to 262144 elements, relative to the sum of magnitudes
SUMS_BOUND = 1e-4
# tiny fp32 pipeline, card vs CPU, pixels in [0, 1]
WIRING_BOUND = 2e-3

KERNEL_META = {
    'attn_fwd': ('cuda', 'mixofshow_tpu_torch/csrc/attn_fwd.cu',
                 'mixofshow_tpu/ops/fused_attention.py:248'),
    'gn_spatial_sums': ('triton', 'mixofshow_tpu_torch/ops/gn_stats_triton.py',
                        'mixofshow_tpu/ops/gn_stats.py:29'),
    'attn_block': ('cuda', 'mixofshow_tpu_torch/csrc/gemm_bias.cu',
                   'mixofshow_tpu/ops/fused_attention.py:63'),
    'region_attn': ('cuda', 'mixofshow_tpu_torch/csrc/region_attn.cu',
                    'mixofshow_tpu/ops/region_attention.py:66'),
}
PLAIN_PATH_KERNELS = ('attn_fwd', 'gn_spatial_sums', 'attn_block')
# bench.py's three near-full-height boxes, (start_h, start_w, end_h, end_w)
REGIONS = [('a <potter1> <potter2>, in a jacket', 'low quality',
            [0.02, 0.05, 0.95, 0.30]),
           ('a <hermione1> <hermione2>, in a dress', 'low quality',
            [0.02, 0.35, 0.95, 0.62]),
           ('a <thanos1> <thanos2>, with armor', 'low quality',
            [0.02, 0.68, 0.95, 0.97])]
CONCEPTS = '<potter1> <potter2>+<hermione1> <hermione2>+<thanos1> <thanos2>'
POSE = Path(__file__).resolve().parent / 'datasets' / \
    'validation_spatial_condition' / 'multi-characters' / 'real_pose' / \
    'potter_hermione_thanos_pose.png'


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def phase_build(dev):
    t0 = time.perf_counter()
    _build.cuda_lib()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dt in (torch.bfloat16, torch.float32):
        gs.spatial_sums(torch.ones(1, 8, 4, 4, device=dev, dtype=dt))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f'[build] nvcc K1+K3+K7 library: {t_cuda:.2f} s '
          f'({_build.library_path().name}); Triton K2 JIT (bf16+fp32): '
          f'{t_triton:.2f} s', flush=True)


def phase_kernels(dev):
    """Each kernel vs its plain version; returns {name: (err, ms, plain_ms)}
    at the first (main-path) shape of each."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale) \
            .to(torch.bfloat16)

    res = {}
    # K1 at the UNet's res-64 and res-32 self-attention (CFG batch of 2
    # prompts), and a ragged kv_len
    for b, s, h, d, sk, kvl in [(4, 4096, 8, 40, 4096, 4096),
                                (4, 1024, 8, 80, 1024, 1024),
                                (2, 1000, 8, 40, 1100, 1037)]:
        q, k, v = randn(b, s, h, d), randn(b, sk, h, d), randn(b, sk, h, d)
        out = fa.attn_fwd(q, k, v, kvl).float()
        ref = fa.attn_fwd_plain(q.float(), k.float(), v.float(), kvl)
        err = (out - ref).abs().max().item()
        ms = cuda_ms(lambda: fa.attn_fwd(q, k, v, kvl))
        pms = cuda_ms(lambda: fa.attn_fwd_plain(q, k, v, kvl))
        print(f'[kernels] attn_fwd (B,S,H,D)=({b},{s},{h},{d}) Sk={sk} '
              f'kv_len={kvl}: max_abs_err {err:.3e} (bound {ATTN_BOUND}); '
              f'kernel {ms:.4f} ms, plain {pms:.4f} ms', flush=True)
        check(math.isfinite(err) and err <= ATTN_BOUND, 'attn_fwd disagrees')
        res.setdefault('attn_fwd', (err, ms, pms))
    # K2 at the VAE decoder's GroupNorm inputs (2 images): NHWC
    # (2,64,64,512), (2,256,256,256), (2,512,512,128) held NCHW
    for shape in [(2, 128, 512, 512), (2, 512, 64, 64), (2, 256, 256, 256)]:
        x = randn(*shape)
        s1, s2 = gs.spatial_sums(x)
        r1, r2 = gs.spatial_sums_plain(x)
        mag = x.float().abs().sum(dim=(2, 3))
        err = max((s1 - r1).abs().max().item(), (s2 - r2).abs().max().item())
        rel = max(((s1 - r1).abs() / mag).max().item(),
                  ((s2 - r2).abs() / r2).max().item())
        ms = cuda_ms(lambda: gs.spatial_sums(x))
        pms = cuda_ms(lambda: gs.spatial_sums_plain(x))
        print(f'[kernels] gn_spatial_sums (B,C,H,W)={shape}: max_abs_err '
              f'{err:.3e}, relative {rel:.3e} (bound {SUMS_BOUND}); kernel '
              f'{ms:.4f} ms, plain {pms:.4f} ms', flush=True)
        check(math.isfinite(rel) and rel <= SUMS_BOUND,
              'gn_spatial_sums disagrees')
        res.setdefault('gn_spatial_sums', (err, ms, pms))
    # K3 at the VAE mid-block: 2 images, 64x64 tokens, C=512, one head
    c = 512
    x = randn(2, 4096, c)
    w = [randn(c, c, scale=c ** -0.5) for _ in range(4)]
    bias = [randn(c, scale=0.1) for _ in range(4)]
    args = (x, x, *w, bias[3], 1, *bias[:3])
    out = fa.attention_block(*args).float()
    ref = fa.attention_block_plain(*(a.float() if torch.is_tensor(a) else a
                                     for a in args))
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda: fa.attention_block(*args))
    pms = cuda_ms(lambda: fa.attention_block_plain(*args))
    print(f'[kernels] attn_block (B,S,C)=(2,4096,512) heads=1 with biases: '
          f'max_abs_err {err:.3e} (bound {ATTN_BOUND}); kernel {ms:.4f} ms, '
          f'plain {pms:.4f} ms', flush=True)
    check(math.isfinite(err) and err <= ATTN_BOUND, 'attn_block disagrees')
    res['attn_block'] = (err, ms, pms)
    # K7 at the regional path's cross-attention layers: 2 images x CFG,
    # 8 heads, 77 keys, the three boxes of REGIONS
    boxes = [box for _, _, box in REGIONS]
    for hw, d in [(64, 40), (32, 80), (16, 160), (8, 160)]:
        b, h, sk = 4, 8, 77
        q = randn(b, hw * hw, h, d)
        gk, gv = randn(b, sk, h, d), randn(b, sk, h, d)
        rk, rv = randn(3, b, sk, h, d), randn(3, b, sk, h, d)
        px = ra.boxes_to_grid(boxes, hw, hw)
        args = (q, gk, gv, rk, rv, px, (hw, hw))
        out = ra.region_attention(*args).float()
        ref = ra.region_attention_plain(*(a.float() if torch.is_tensor(a)
                                          else a for a in args))
        err = (out - ref).abs().max().item()
        ms = cuda_ms(lambda: ra.region_attention(*args))
        pms = cuda_ms(lambda: ra.region_attention_plain(*args))
        print(f'[kernels] region_attn (B,N,H,D)=({b},{hw}x{hw},{h},{d}) '
              f'Sk={sk} R=3: max_abs_err {err:.3e} (bound {ATTN_BOUND}); '
              f'kernel {ms:.4f} ms, plain {pms:.4f} ms', flush=True)
        check(math.isfinite(err) and err <= ATTN_BOUND,
              'region_attn disagrees')
        res.setdefault('region_attn', (err, ms, pms))
    return res


def _tiny_pipes(dev, cls, concepts, **extra):
    """The same tiny fp32 pipeline on the card and on the CPU."""
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    cfg, table = init_concepts(b.tokenizer, concepts, None,
                               b.text_encoder.token_embedding.weight)
    mods = (b.unet, b.text_encoder, b.vae)
    kw = dict(dtype=torch.float32, new_concept_cfg=cfg,
              concept_embedding=table)
    gpu = cls(*copy.deepcopy(mods), b.tokenizer, dev, **kw,
              **copy.deepcopy(extra))
    cpu = cls(*mods, b.tokenizer, 'cpu', **kw, **extra)
    return gpu, cpu


def _wiring_run(name, gpu, cpu, args, kw, expect):
    ops.reset_launch_counts()
    img_gpu = gpu(*args, **kw)
    counts = ops.launch_counts()
    img_cpu = cpu(*args, **kw)
    err = float(np.abs(img_gpu - img_cpu).max())
    print(f'[wiring] {name}: tiny fp32 512x512 2 steps, card vs CPU: '
          f'max_abs_err {err:.3e} (bound {WIRING_BOUND}); launches {counts}',
          flush=True)
    check(img_gpu.shape == img_cpu.shape and img_gpu.shape[1:] ==
          (512, 512, 3), f'wiring: {name} gave {img_gpu.shape}')
    check(all(counts[k] > 0 for k in expect),
          f'wiring: {name}: a kernel did not launch: {counts}')
    check(np.isfinite(img_gpu).all() and err <= WIRING_BOUND,
          f'wiring: {name}: card and CPU disagree')


def phase_wiring(dev):
    exact_fp32()
    lat = torch.randn((2, 4, 64, 64),
                      generator=torch.Generator().manual_seed(0))
    kw = dict(height=512, width=512, num_inference_steps=2,
              guidance_scale=7.5, output_type='np')
    gpu, cpu = _tiny_pipes(dev, EDLoRAPipeline, '<c1>+<c2>')
    _wiring_run('edlora', gpu, cpu,
                (['a photo of <c1> at the beach', 'a <c2> in a garden'],),
                dict(kw, latents=lat), PLAIN_PATH_KERNELS)
    gpu, cpu = _tiny_pipes(
        dev, RegionallyT2IAdapterPipeline, '<c1>+<c2>',
        keypose_adapter=zoo.load_t2i_adapter('keypose', 'tiny', 'cpu',
                                             seed=3))
    layout = [('two friends in a park',
               [('a <c1>', 'blurry', [0.0, 0.05, 1.0, 0.5]),
                ('a <c2>', '', [0.1, 0.4, 0.9, 0.95])])]
    _wiring_run('regional', gpu, cpu, (layout,),
                dict(kw, latents=lat[:1], negative_prompt='low quality',
                     keypose_adapter_input=Image.open(POSE).convert('RGB')),
                tuple(KERNEL_META))


def phase_main(dev, card):
    t0 = time.perf_counter()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    cfg, table = init_concepts(b.tokenizer, '<cat1>+<dog2>', None,
                               b.text_encoder.token_embedding.weight)
    pipe = EDLoRAPipeline(b.unet, b.text_encoder, b.vae, b.tokenizer, dev,
                          torch.bfloat16, new_concept_cfg=cfg,
                          concept_embedding=table)
    torch.cuda.synchronize()
    print(f'[main] SD1.5 bf16 random init on the card: '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    prompts = ['a photo of <cat1> sitting on a sofa, best quality',
               '<dog2> running on the beach at sunset']
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    kw = dict(height=512, width=512, num_inference_steps=50,
              guidance_scale=7.5, latents=lat, output_type='uint8')

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_call = pipe(prompts, **kw)
    t_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    pending = pipe.submit(prompts, **kw)
    t_queued = time.perf_counter() - t0
    out_submit = pending.result()
    t_submit = time.perf_counter() - t0
    counts = ops.launch_counts()

    for name, out in (('__call__', out_call), ('submit', out_submit)):
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f'main: {name} gave {out.shape} {out.dtype}')
        check(all(int(im.max()) > int(im.min()) for im in out),
              f'main: {name} gave a constant image')
    check(np.array_equal(out_call, out_submit),
          'main: two runs with the same latents differ')
    check(all(counts[k] > 0 for k in PLAIN_PATH_KERNELS),
          f'main: a kernel did not launch: {counts}')
    print(f'[main] 2 prompts 512x512, 50 steps, CFG 7.5: __call__ '
          f'{t_call:.3f} s ({2 / t_call:.4f} img/s, first request), '
          f'submit().result() {t_submit:.3f} s ({2 / t_submit:.4f} img/s; '
          f'submit() returned after {t_queued:.3f} s); {card}; launches '
          f'{counts}', flush=True)
    return counts


def phase_regional(dev, card):
    t0 = time.perf_counter()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    cfg, table = init_concepts(b.tokenizer, CONCEPTS, None,
                               b.text_encoder.token_embedding.weight)
    adapter = zoo.load_t2i_adapter('keypose', 'sd15', dev, seed=3,
                                   dtype=torch.bfloat16)
    pipe = RegionallyT2IAdapterPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, dev, torch.bfloat16,
        new_concept_cfg=cfg, concept_embedding=table,
        keypose_adapter=adapter)
    torch.cuda.synchronize()
    print(f'[regional] SD1.5 bf16 + keypose adapter, random init on the '
          f'card: {time.perf_counter() - t0:.2f} s', flush=True)
    layout = [('three people standing in a park, best quality', REGIONS)]
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    kw = dict(keypose_adapter_input=Image.open(POSE).convert('RGB'),
              height=512, width=512, num_inference_steps=50,
              guidance_scale=7.5, num_images_per_prompt=2, latents=lat,
              output_type='uint8')

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_call = pipe(layout, **kw)
    t_call = time.perf_counter() - t0
    first = ops.launch_counts()
    t0 = time.perf_counter()
    pending = pipe.submit(layout, **kw)
    t_queued = time.perf_counter() - t0
    out_submit = pending.result()
    t_submit = time.perf_counter() - t0
    counts = ops.launch_counts()
    second = {k: counts[k] - first[k] for k in counts}

    for name, out in (('__call__', out_call), ('submit', out_submit)):
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f'regional: {name} gave {out.shape} {out.dtype}')
        check(all(int(im.max()) > int(im.min()) for im in out),
              f'regional: {name} gave a constant image')
    check(np.array_equal(out_call, out_submit),
          'regional: two runs with the same latents differ')
    for req in (first, second):
        check(req['region_attn'] == 16 * 50 and
              all(req[k] > 0 for k in PLAIN_PATH_KERNELS),
              f'regional: launches per request {first}, {second}')
    print(f'[regional] 3 regions, keypose, 2 images 512x512, 50 steps, CFG '
          f'7.5: __call__ {t_call:.3f} s ({2 / t_call:.4f} img/s, first '
          f'request), submit().result() {t_submit:.3f} s ({2 / t_submit:.4f}'
          f' img/s; submit() returned after {t_queued:.3f} s); {card}; '
          f'launches per request {first}, {second}', flush=True)
    return counts


def main():
    dev = require_cuda()
    card = smi_line()
    print(f'[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | '
          f'torch {torch.__version__} CUDA {torch.version.cuda}', flush=True)
    phase_build(dev)
    kres = phase_kernels(dev)
    phase_wiring(dev)
    plain = phase_main(dev, card)
    regional = phase_regional(dev, card)
    kernels = [{'name': name, 'route': route, 'source': src,
                'replaces': rep, 'launches': plain[name] + regional[name],
                'max_abs_err': kres[name][0], 'ms': kres[name][1],
                'plain_ms': kres[name][2]}
               for name, (route, src, rep) in KERNEL_META.items()]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
