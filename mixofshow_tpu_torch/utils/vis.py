"""Validation visualization: prompt-labelled sample grids.

Port of mixofshow_tpu/utils/vis.py (reference mixofshow/utils/util.py:
232-313): per-image PNGs and a grid in which each column is one prompt,
its caption strip drawn above its samples. PIL only; the same file names,
font and layout as the JAX package.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
from PIL import Image, ImageDraw, ImageFont

FONT = '/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf'


def pil_imwrite(img: Image.Image, file_path: str, auto_mkdir: bool = True):
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    img.save(file_path)


def draw_prompt(text: str, height: int, width: int,
                font_size: int = 45) -> Image.Image:
    """White strip with the wrapped prompt text (util.py:251-276)."""
    img = Image.new('RGB', (width, height), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.truetype(FONT, font_size)
    except OSError:
        font = ImageFont.load_default()
    # naive wrap: about width / (0.6 font_size) characters a line
    per_line = max(int(width / (0.6 * font_size)), 8)
    lines, cur = [], ''
    for w in text.split():
        if len(cur) + len(w) + 1 > per_line:
            lines.append(cur)
            cur = w
        else:
            cur = f'{cur} {w}'.strip()
    lines.append(cur)
    y = 10
    for line in lines:
        draw.text((10, y), line, fill=(0, 0, 0), font=font)
        y += int(font_size * 1.2)
    return img


def compose_visualize(dir_path: str) -> str:
    """Compose the per-image PNGs of a directory into one labelled grid,
    `<dir>---composed.jpg` beside it (util.py:279-313). File names follow
    '<prompt>---G_<scale>_S_<steps>---<index>.png'."""
    files = sorted(f for f in os.listdir(dir_path) if f.endswith('.png'))
    prompts: Dict[str, List[str]] = {}
    for f in files:
        prompts.setdefault(f.split('---')[0], []).append(f)
    if not prompts:
        raise ValueError(f'no sample PNGs found in {dir_path}')

    cols = []
    cell_w = cell_h = None
    n_rows = max(len(v) for v in prompts.values())
    for prompt, fs in prompts.items():
        imgs = [Image.open(os.path.join(dir_path, f)) for f in fs]
        cell_w, cell_h = imgs[0].size
        strip = draw_prompt(prompt.replace('_', ' '), height=cell_h // 3,
                            width=cell_w, font_size=max(cell_w // 12, 16))
        col = Image.new('RGB', (cell_w, cell_h // 3 + n_rows * cell_h),
                        (255, 255, 255))
        col.paste(strip, (0, 0))
        for i, im in enumerate(imgs):
            col.paste(im, (0, cell_h // 3 + i * cell_h))
        cols.append(col)

    total = Image.new('RGB', (cell_w * len(cols), cols[0].size[1]),
                      (255, 255, 255))
    for i, col in enumerate(cols):
        total.paste(col, (i * cell_w, 0))
    out_path = os.path.join(os.path.dirname(dir_path),
                            os.path.basename(dir_path) + '---composed.jpg')
    total.save(out_path, quality=92)
    return out_path


def array_to_pil(arr: np.ndarray) -> Image.Image:
    """(H, W, 3) float in [0, 1] -> PIL."""
    return Image.fromarray((np.clip(arr, 0, 1) * 255).round().astype(np.uint8))


def safe_filename(text: str, maxlen: int = 100) -> str:
    return re.sub(r'[^\w\-.<> ]', '_', text)[:maxlen]
