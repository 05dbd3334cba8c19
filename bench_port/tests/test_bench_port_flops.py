"""The model-FLOP arithmetic of bench_port/flops.py against
torch.utils.flop_counter on the plain reference's modules: at tiny widths
on the CPU, and at the configurations' own widths on the meta device."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import build, flops
from bench_port import manifest as mf
from bench_port.tests.tiny import TinyManifest

M = mf.Manifest()


def counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def configs(tmp_path):
    tiny = TinyManifest(tmp_path)
    out = []
    for w in M.data['workloads']:
        out.append(('full', M.config(w)))
        out.append(('tiny', tiny.config(w)))
    return out


@pytest.mark.parametrize('size', ['tiny', 'full'])
def test_counts_match_flop_counter(size, tmp_path):
    for kind, cfg in configs(tmp_path):
        if kind != size:
            continue
        device = 'meta' if size == 'full' else 'cpu'
        mods = build.reference_modules(cfg)
        if size == 'tiny':
            mods = {k: m.to_empty(device='cpu') for k, m in mods.items()}
        u, v, c = cfg['unet'], cfg['vae'], cfg['text_encoder']
        h, w = 24, 40
        with torch.device(device), torch.no_grad():
            x = torch.zeros(2, 4, h, w)
            ctx = torch.zeros(2, 16, 77, u['cross_attention_dim'])
            assert counted(mods['unet'], x, 7, ctx) == \
                flops.unet_forward(u, h, w, rows=2)
            assert counted(mods['vae'].decode, x) == \
                flops.vae_decode(v, h, w, rows=2)
            img = torch.zeros(1, 3, 8 * h, 8 * w)
            assert counted(mods['vae'].encode, img) == \
                flops.vae_encode(v, 8 * h, 8 * w)
            ids = torch.zeros(3, 77, dtype=torch.long)
            assert counted(mods['text_encoder'], ids) == \
                flops.clip_text(c, 3)
            if 'adapter' in mods:
                a = cfg['adapter']
                cond = torch.zeros(1, a['in_channels'], 8 * h, 8 * w)
                assert counted(mods['adapter'], cond) == \
                    flops.adapter(a, 8 * h, 8 * w)


def test_sd15_counts_are_the_published_sizes():
    cfg = M.config(M.cell('edlora-sample-512'))
    assert round(flops.unet_forward(cfg['unet'], 64, 64) / 1e9) == 803
    assert round(flops.vae_decode(cfg['vae'], 32, 32) / 1e9) == 622
    assert round(flops.clip_text(cfg['text_encoder']) / 1e9) == 13


def test_attention_work_counts_the_k1_layers():
    cfg = M.config(M.cell('edlora-sample-512'))
    # 512x512: the 64x64 and 32x32 layers, 2 + 3 of each
    work = flops.self_attention_work(cfg['unet'], 64, 64, 8, 1024)
    assert len(work) == 10
    f, b = work[0]
    assert f == 4 * 8 * 4096 * 4096 * 320 and b == 4 * 8 * 4096 * 320 * 2
    # the K1 row of PERF.md's kernel table: (8,4096,8,40), 0.1737 ms least
    assert flops.least_s(f, b) * 1e3 == pytest.approx(0.1737, rel=1e-3)
    cfg2 = M.config(M.cell('regional-2x-keypose'))
    assert len(flops.self_attention_work(cfg2['unet'], 128, 256, 2,
                                         1024)) == 15
