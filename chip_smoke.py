#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mixofshow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero without a result
line when any fails, or when no CUDA device is visible):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc-builds the CUDA kernels from csrc/ into .torch_ext/ and
                JIT-compiles the Triton kernel, timing each;
  3. kernels  — each kernel against its plain PyTorch version on the same
                inputs at the main path's shapes, error against a stated
                bound, and both times from CUDA events;
  4. wiring   — the tiny config through EDLoRAPipeline at 512x512 in fp32
                (TF32 off), 2 steps, on the card and on the CPU, images
                compared; all three kernels engage at this size;
  5. main     — SD1.5-width UNet, CLIP and VAE in bf16, random weights from
                a seeded generator on the card, two concept tokens; two
                requests of 2 prompts at 512x512, CFG 7.5, 50 DPM-Solver++
                steps, one through __call__ and one through
                submit().result(), uint8 output. Checks shapes, that the
                images are not constant and identical across the two
                requests (same latents), and that every kernel launched.
Then one JSON line with the kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""
import copy
import json
import math
import subprocess
import time

import numpy as np
import torch

from mixofshow_tpu_torch import ops, zoo
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import fused_attention as fa
from mixofshow_tpu_torch.ops import gn_stats as gs
from mixofshow_tpu_torch.pipelines import EDLoRAPipeline, init_concepts
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
}


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
    print(f'[build] nvcc K1+K3 library: {t_cuda:.2f} s '
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
    return res


def _tiny_pipes(dev):
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    cfg, table = init_concepts(b.tokenizer, '<c1>+<c2>', None,
                               b.text_encoder.token_embedding.weight)
    mods = (b.unet, b.text_encoder, b.vae)
    kw = dict(dtype=torch.float32, new_concept_cfg=cfg,
              concept_embedding=table)
    gpu = EDLoRAPipeline(*copy.deepcopy(mods), b.tokenizer, dev, **kw)
    cpu = EDLoRAPipeline(*mods, b.tokenizer, 'cpu', **kw)
    return gpu, cpu


def phase_wiring(dev):
    exact_fp32()
    gpu, cpu = _tiny_pipes(dev)
    prompts = ['a photo of <c1> at the beach', 'a <c2> in a garden']
    lat = torch.randn((2, 4, 64, 64),
                      generator=torch.Generator().manual_seed(0))
    kw = dict(height=512, width=512, num_inference_steps=2,
              guidance_scale=7.5, latents=lat, output_type='np')
    ops.reset_launch_counts()
    img_gpu = gpu(prompts, **kw)
    counts = ops.launch_counts()
    img_cpu = cpu(prompts, **kw)
    err = float(np.abs(img_gpu - img_cpu).max())
    print(f'[wiring] tiny fp32 512x512 2 steps, card vs CPU: max_abs_err '
          f'{err:.3e} (bound {WIRING_BOUND}); launches {counts}', flush=True)
    check(img_gpu.shape == (2, 512, 512, 3), 'wiring: wrong shape')
    check(all(n > 0 for n in counts.values()),
          f'wiring: a kernel did not launch: {counts}')
    check(np.isfinite(img_gpu).all() and err <= WIRING_BOUND,
          'wiring: card and CPU disagree')


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
    check(all(n > 0 for n in counts.values()),
          f'main: a kernel did not launch: {counts}')
    print(f'[main] 2 prompts 512x512, 50 steps, CFG 7.5: __call__ '
          f'{t_call:.3f} s ({2 / t_call:.4f} img/s, first request), '
          f'submit().result() {t_submit:.3f} s ({2 / t_submit:.4f} img/s; '
          f'submit() returned after {t_queued:.3f} s); {card}; launches '
          f'{counts}', flush=True)
    return counts


def main():
    dev = require_cuda()
    card = smi_line()
    print(f'[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | '
          f'torch {torch.__version__} CUDA {torch.version.cuda}', flush=True)
    phase_build(dev)
    kres = phase_kernels(dev)
    phase_wiring(dev)
    counts = phase_main(dev, card)
    kernels = [{'name': name, 'route': route, 'source': src,
                'replaces': rep, 'launches': counts[name],
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
