"""Every distinct UNet convolution of the 2x regional eval and the 512x512
sampling eval, timed on the card in NCHW and in channels-last.

The shapes come from one eval of each kind through the SD1.5-width UNet
(bf16, seeded random weights): the 2x canvas's latent (2, 4, 128, 256) (one
image, CFG) and the sampling cell's (8, 4, 64, 64) (4 prompts, CFG), with
each shape's calls counted per eval. Each shape then runs alone through
F.conv2d with its bias: input and weight NCHW-contiguous ('nchw'); the
same with weight and bias as views 8 bytes past a 16-byte boundary
('nchw_8B': where a state dict's tensors carved out of one flat buffer at
odd multiples of 4 elements put them, as bench_port/weights.draw does);
input and weight channels-last ('nhwc'). Per layout: device ms per call
(CUDA events behind a sleep kernel, chip_smoke.cuda_ms), TFLOP/s by
bench_port/flops.conv, and the kernels the call launched (torch.profiler,
rows whose device type is CUDA). cudnn.benchmark stays off: the kernels
are cuDNN's heuristic picks, as the program gets them.

    python tools/port_conv_layouts.py

Prints one line a shape, the conv ms of each eval in each layout, and
last one line CONV_LAYOUTS {json}: the card, torch and cuDNN versions, a
row a shape (calls an eval, and per layout ms, TFLOP/s and kernels) and
each eval's totals.
"""
import json
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bench_port import flops  # noqa: E402
from mixofshow_tpu_torch import zoo  # noqa: E402
from mixofshow_tpu_torch.models import unet as unet_mod  # noqa: E402

# (name, latent shape (rows, 4, h, w), evals a request)
EVALS = (('regional-2x', (2, 4, 128, 256), 50),
         ('sample-512', (8, 4, 64, 64), 50))
LAYOUTS = ('nchw', 'nchw_8B', 'nhwc')


def conv_shapes(unet, latent, ctx_len=77):
    """Counter of (N, Cin, H, W, Cout, k, stride, padding) over the conv2d
    calls of one eval of `unet` at `latent`."""
    seen = Counter()
    inner = unet_mod.conv2d

    def record(x, conv, lora=None, alpha=1.0):
        seen[(*x.shape, conv.out_channels, conv.kernel_size[0],
              conv.stride[0], conv.padding[0])] += 1
        return inner(x, conv, lora, alpha)

    p = next(unet.parameters())
    x = torch.randn(latent, device=p.device, dtype=p.dtype)
    ctx = torch.randn(latent[0], ctx_len, unet.cfg.cross_attention_dim,
                      device=p.device, dtype=p.dtype)
    unet_mod.conv2d = record
    try:
        with torch.inference_mode():
            unet(x, torch.tensor(500.0, device=p.device), ctx,
                 fuse_attention='packed')
    finally:
        unet_mod.conv2d = inner
    return seen


def kernels_of(fn, calls=3):
    """[(kernel name, device ms a call)] of `fn`, largest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def at_8_bytes(t):
    """A copy of contiguous bf16 `t` 8 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[4:].view(t.shape)
    out.copy_(t)
    return out


def time_shape(key, dev):
    n, cin, h, w, cout, k, stride, pad = key
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, cin, h, w), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    wt = torch.randn((cout, cin, k, k), device=dev, generator=gen,
                     dtype=torch.bfloat16) / (cin * k * k) ** 0.5
    bias = torch.randn((cout,), device=dev, generator=gen,
                       dtype=torch.bfloat16)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    ops = flops.conv(cin, cout, k, n * ho * wo)
    out, ref = {}, None
    for name in LAYOUTS:
        fmt = torch.channels_last if name == 'nhwc' else \
            torch.contiguous_format
        xi = x.contiguous(memory_format=fmt)
        wi = wt.contiguous(memory_format=fmt)
        bi = bias
        if name == 'nchw_8B':
            wi, bi = at_8_bytes(wt), at_8_bytes(bias)

        def call():
            return F.conv2d(xi, wi, bi, stride, pad)

        y = call()
        ref = y if ref is None else ref
        err = float((y.float() - ref.float()).abs().max())
        ms = cs.cuda_ms(call, iters=20, warmup=3)
        out[name] = {'ms': ms, 'tflops': ops / ms / 1e9,
                     'max_abs_diff_vs_nchw': err,
                     'out_channels_last': y.is_contiguous(
                         memory_format=torch.channels_last),
                     'kernels': [(kn[:100], round(t, 4))
                                 for kn, t in kernels_of(call)]}
    out['speedup'] = out['nchw']['ms'] / out['nhwc']['ms']
    out['speedup_8B'] = out['nchw_8B']['ms'] / out['nhwc']['ms']
    out['gflop'] = ops / 1e9
    return out


def main():
    dev = torch.device('cuda')
    card = cs.smi_line()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    counts = {name: conv_shapes(b.unet, latent) for name, latent, _ in EVALS}
    del b
    torch.cuda.empty_cache()
    keys = sorted(set().union(*counts.values()))
    print(f'[convs] {card}; torch {torch.__version__}, cuDNN '
          f'{torch.backends.cudnn.version()}; {len(keys)} distinct shapes',
          flush=True)
    rows = []
    for key in keys:
        r = time_shape(key, dev)
        r['shape'] = dict(zip(('n', 'cin', 'h', 'w', 'cout', 'k', 'stride',
                               'padding'), key))
        r['calls'] = {name: counts[name][key] for name, *_ in EVALS}
        rows.append(r)
        print(f'[convs] {key} calls {r["calls"]}: ' + ' | '.join(
            f'{lay} {r[lay]["ms"]:.4f} ms {r[lay]["tflops"]:.0f} TF/s '
            f'{[k[:60] for k, _ in r[lay]["kernels"][:3]]}'
            for lay in LAYOUTS) + f' | nhwc {r["speedup"]:.2f}x and '
            f'{r["speedup_8B"]:.2f}x faster; outputs differ by '
            f'{r["nhwc"]["max_abs_diff_vs_nchw"]:.3g}', flush=True)
    totals = {}
    for name, _, evals in EVALS:
        t = {lay: sum(r['calls'][name] * r[lay]['ms'] for r in rows)
             for lay in LAYOUTS}
        gflop = sum(r['calls'][name] * r['gflop'] for r in rows)
        totals[name] = {'conv_ms_per_eval': t, 'gflop_per_eval': gflop,
                        'conv_s_per_request': {lay: v * evals / 1e3
                                               for lay, v in t.items()},
                        'shapes_faster_1_5x': sum(
                            r['speedup'] >= 1.5 for r in rows
                            if r['calls'][name]),
                        'shapes_faster_1_5x_than_8B': sum(
                            r['speedup_8B'] >= 1.5 for r in rows
                            if r['calls'][name]),
                        'shapes': sum(1 for r in rows if r['calls'][name])}
        print(f'[convs] {name}: {gflop:.0f} GFLOP of convs an eval; ' +
              ', '.join(f'{lay} {t[lay]:.2f} ms ({gflop / t[lay]:.0f} TF/s)'
                        for lay in LAYOUTS) +
              f' an eval; nhwc 1.5x or more faster than nchw in '
              f'{totals[name]["shapes_faster_1_5x"]}, than nchw_8B in '
              f'{totals[name]["shapes_faster_1_5x_than_8B"]} of '
              f'{totals[name]["shapes"]} shapes', flush=True)
    result = {'card': card, 'torch': torch.__version__,
              'cudnn': torch.backends.cudnn.version(), 'rows': rows,
              'totals': totals}
    print('CONV_LAYOUTS ' + json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
