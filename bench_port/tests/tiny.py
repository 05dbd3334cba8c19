"""The benchmark's manifest at a size a CPU test run holds: each cell's
configuration cut to the port's tiny widths, its traffic to a small canvas
and a few steps. Only the tests use it; the benchmark never runs cut."""
from __future__ import annotations

import copy
from pathlib import Path

from PIL import Image

from bench_port import manifest as mf

TINY = {'unet': dict(block_out_channels=[32, 64, 128, 128],
                     cross_attention_dim=64, attention_heads=2,
                     norm_groups=8, sample_size=16),
        'text_encoder': dict(width=64, layers=2, heads=2, mlp_dim=128),
        'vae': dict(block_out_channels=[16, 32, 32, 32], norm_groups=8),
        'adapter': dict(channels=[32, 64, 128, 128], num_res_blocks=1)}
# the latents' limit at these widths and steps, set as the cells' own are
# (bench_port/readings.py on the CPU, 12 seeds, both sampling cells):
# bf16 reads at most 0.0326, the program's int8+conv path at least
# 0.0566, the float8 reference at least 0.172
TINY_LIMITS = {'lat_rel': 0.045}


class TinyManifest(mf.Manifest):
    """BENCHMARK.json's cells with tiny widths, `steps` steps, 64×64
    images, the regional canvas scaled to 128×256 (its layout's boxes
    scale with it), training at 256×256, and the limits of TINY_LIMITS."""

    def __init__(self, tmp: Path, steps: int = 3):
        super().__init__()
        self.tmp, self.steps = Path(tmp), steps

    def config(self, cell):
        cfg = copy.deepcopy(super().config(cell))
        for k, v in TINY.items():
            if k in cfg:
                cfg[k].update(v)
        return cfg

    def judgement(self, cell):
        j = copy.deepcopy(super().judgement(cell))
        for k, v in TINY_LIMITS.items():
            if k in j['limits']:
                j['limits'][k] = v
        return j

    def traffic(self, cell):
        t = super().traffic(cell)
        t['steps'] = self.steps
        if 'height' in t:
            t['height'] = t['width'] = 64
        for step in t.get('dataset', {}).get('instance_transform', []):
            if 'size' in step:
                step['size'] = 256
        if 'pose' in t:
            img = Image.open(mf.PKG / t['pose'])
            small = self.tmp / 'pose.png'
            img.resize((img.size[0] // 8, img.size[1] // 8)).save(small)
            t['pose'] = str(small)
            layout = (mf.PKG / t['layout']).read_text()
            scaled = self.tmp / 'layout.txt'
            scaled.write_text(_scale_boxes(layout, 8))
            t['layout'] = str(scaled)
        return t


def _scale_boxes(layout: str, k: int) -> str:
    import re

    def box(m):
        vals = [int(v) // k for v in re.findall(r'-?\d+', m.group(1))]
        return f"='[{', '.join(map(str, vals))}]'"
    return re.sub(r"='(\[[^\]]*\])'", box, layout)
