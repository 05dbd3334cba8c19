"""Where a regional request's time goes on the card: chip_smoke.py phase 6's
request (SD1.5 width, bf16, seeded random weights, a full-width keypose
adapter, three concepts in three boxes, 2 images at 512x512, CFG 7.5), two
50-step requests timed on the host clock, then one 5-step request under
torch.profiler: the device time of every kernel (rows whose device type is
CUDA), grouped, each group's share of the device time, and the device's
busy share of the profiled window.

    python tools/port_profile_regional.py

Prints the request times, the top kernels and one line PROFILE {json}.
"""
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
from PIL import Image  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mixofshow_tpu_torch import zoo  # noqa: E402
from mixofshow_tpu_torch.pipelines import (  # noqa: E402
    RegionallyT2IAdapterPipeline, init_concepts)

# kernel name fragments -> group, first match wins
GROUPS = [('K1 attn_fwd', ('attn_fwd_bf16',)),
          ('K7 region_attn', ('region_attn',)),
          ('K3 attn_block', ('attn_wide', 'gemm_grouped', 'gemm_hopper')),
          ('K2/K8 GroupNorm', ('spatial_sums', '_apply_kernel', 'gn_')),
          ('layout transposes', ('nchwToNhwc', 'nhwcToNchw')),
          ('convolutions', ('conv', 'cudnn', 'implicit_gemm', 'xmma_fprop',
                            'sm90_xmma_fprop')),
          ('matmuls', ('gemm', 'cutlass', 'xmma', 'nvjet')),
          ('elementwise and reductions', ('elementwise', 'reduce', 'copy',
                                          'Memcpy', 'Memset', 'softmax',
                                          'cat', 'index'))]


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return 'other'


def main():
    dev = torch.device('cuda')
    card = cs.smi_line()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    cfg, table = init_concepts(b.tokenizer, cs.CONCEPTS, None,
                               b.text_encoder.token_embedding.weight)
    adapter = zoo.load_t2i_adapter('keypose', 'sd15', dev, seed=3,
                                   dtype=torch.bfloat16)
    pipe = RegionallyT2IAdapterPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, dev, torch.bfloat16,
        new_concept_cfg=cfg, concept_embedding=table,
        keypose_adapter=adapter)
    layout = [('three people standing in a park, best quality', cs.REGIONS)]
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    kw = dict(keypose_adapter_input=Image.open(cs.POSE).convert('RGB'),
              height=512, width=512, guidance_scale=7.5,
              num_images_per_prompt=2, latents=lat, output_type='uint8')
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(layout, num_inference_steps=50, **kw)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(layout, num_inference_steps=5, **kw)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)   # µs
    groups = defaultdict(float)
    for e in kernels:
        groups[group_of(e.key)] += e.self_device_time_total
    print(f'[profile] {card}; 50-step requests (first, second): '
          f'{times[0]:.3f} s, {times[1]:.3f} s', flush=True)
    print(f'[profile] 5-step request: window {window * 1e3:.1f} ms on the '
          f'host clock, {total / 1e3:.1f} ms of kernels, device busy '
          f'{total / 1e6 / window:.3%}, {sum(e.count for e in kernels)} '
          'kernel launches', flush=True)
    for name, t in sorted(groups.items(), key=lambda x: -x[1]):
        print(f'[profile]   {name}: {t / 1e3:.2f} ms, {t / total:.1%}')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f'[profile]   {e.self_device_time_total / 1e3:8.2f} ms '
              f'{e.count:6d}x {e.key[:110]}')
    print('PROFILE ' + json.dumps({
        'card': card, 'request_s': times, 'window_s': window,
        'kernel_ms': total / 1e3, 'busy': total / 1e6 / window,
        'groups_ms': {k: v / 1e3 for k, v in groups.items()}}), flush=True)


if __name__ == '__main__':
    main()
