"""Training data of the ED-LoRA training cells: the synthetic concept the
program trains on, written once from the seed, and a plain reference of
the batches the shipped config makes of it. Imports nothing of the program
under test.

`write_concept` writes `n` seeded 640×512 images with captions and masks
and the concept list (the hermione layout of
datasets/data_cfgs/single-concept/characters/real). `batches` re-derives
the first batches the program's loader gives: the items sorted by name and
shuffled by Python's `random` seeded with the seed, the loader's epoch
order from numpy's default_rng(seed), and per item, in load order, the
config's transforms: HumanResizeCropFinalV3 (size 512, crop_p 0.5: the
short edge to 512, a top-anchored tall crop with probability crop_p, the
result fitted inside 511/512, pasted at a random place on a black canvas,
mask and placement mask at 1/8 by nearest), ToTensor, Normalize(0.5, 0.5),
ShuffleCaption(keep 1), EnhanceText(human). Only the tall-image branch of
the crop is written, since the data here are taller than wide.
"""
from __future__ import annotations

import json
import random
import re
from pathlib import Path

import numpy as np
from PIL import Image

try:
    import cv2
except ImportError:   # the program resizes masks with PIL then too
    cv2 = None

HUMAN_TEMPLATES = [
    'a photo of a {}', 'a photo of one {}', 'a photo of the {}',
    'the photo of a {}', 'a rendering of a {}', 'a rendition of the {}',
    'a rendition of a {}', 'a cropped photo of the {}',
    'a cropped photo of a {}', 'a bad photo of the {}', 'a bad photo of a {}',
    'a photo of a weird {}', 'a weird photo of a {}',
    'a bright photo of the {}', 'a good photo of the {}',
    'a photo of a nice {}', 'a good photo of a {}', 'a photo of a cool {}',
]


def write_concept(root: Path, seed: int, n: int) -> Path:
    """n seeded 640×512 images, masks and captions under `root`; returns
    the concept list's path."""
    rng = np.random.default_rng(seed)
    dirs = {k: root / k for k in ('img', 'mask', 'caption')}
    for d in dirs.values():
        d.mkdir(parents=True)
    yy, xx = np.mgrid[0:640, 0:512]
    for i in range(n):
        base = rng.uniform(0, 255, (1, 1, 3))
        img = base + 40 * np.sin(xx[..., None] / (17 + 5 * i)
                                 + yy[..., None] / 23 + rng.uniform(0, 6, 3))
        img += rng.normal(0, 12, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            dirs['img'] / f'{i}.png')
        m = np.zeros((640, 512), np.uint8)
        m[100 + 20 * (i % 8):560, 96:416 - 10 * (i % 8)] = 255
        Image.fromarray(m).save(dirs['mask'] / f'{i}.png')
        (dirs['caption'] / f'{i}.txt').write_text(
            f'<TOK>, a person in a red coat, photo {i}\n')
    concept = root / 'concept.json'
    concept.write_text(json.dumps([{
        'instance_prompt': '<TOK>', 'instance_data_dir': str(dirs['img']),
        'caption_dir': str(dirs['caption']), 'mask_dir': str(dirs['mask'])}]))
    return concept


def _clean(text, mapping):
    for k, v in mapping.items():
        text = text.replace(k, v)
    return re.sub(' +', ' ', text.strip())


def items(concept_list: Path, mapping: dict, rng: random.Random):
    """(image, caption, mask) paths in the dataset's order."""
    out = []
    for c in json.loads(Path(concept_list).read_text()):
        for p in sorted(Path(c['instance_data_dir']).iterdir()):
            if not p.is_file():
                continue
            cap = Path(c['caption_dir']) / f'{p.stem}.txt'
            out.append((p, _clean(cap.read_text().splitlines()[0], mapping),
                        Path(c['mask_dir']) / f'{p.stem}.png'))
    rng.shuffle(out)
    return out


def _short(img, size, max_size=None, nearest=False):
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(round(size * long / short))
    if max_size is not None and new_long > max_size:
        new_long, new_short = max_size, int(round(max_size * short / long))
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    return img.resize((nw, nh), Image.NEAREST if nearest else Image.BILINEAR)


def _small(arr, size):
    target = (size // 8, size // 8)
    if cv2 is not None:
        return cv2.resize(arr, target, interpolation=cv2.INTER_NEAREST)
    img = Image.fromarray((arr * 255).astype(np.uint8))
    return np.asarray(img.resize(target, Image.NEAREST), np.float32) / 255.0


def transform(img, mask, caption, rng: random.Random, size=512, crop_p=0.5):
    """One item through the config's transforms: (image HWC in [-1, 1],
    mask and placement mask at size/8, caption)."""
    img, mask = _short(img, size), _short(mask, size)
    w, h = img.size
    if rng.random() < crop_p:
        if h <= w:
            raise ValueError('only taller-than-wide images are written')
        pos = rng.randint(0, h - w)
        img = img.crop((0, 0, w, w + pos))
        mask = mask.crop((0, 0, w, w + pos))
    img = _short(img, size - 1, max_size=size)
    mask = _short(mask, size - 1, max_size=size)
    marr = np.asarray(mask, np.float32) / 255.0
    nw, nh = img.size
    y, x = rng.randint(0, size - nh), rng.randint(0, size - nw)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[y:y + nh, x:x + nw] = np.asarray(img)
    placed = np.zeros((size, size), np.float32)
    placed[y:y + nh, x:x + nw] = 1.0
    out_mask = np.zeros((size, size), np.float32)
    out_mask[y:y + nh, x:x + nw] = marr
    arr = np.asarray(Image.fromarray(canvas), np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    parts = [t.strip() for t in caption.strip().split(',')]
    flex = parts[1:]
    rng.shuffle(flex)
    caption = ', '.join(parts[:1] + flex)
    caption = rng.choice(HUMAN_TEMPLATES).format(caption.strip())
    return arr, _small(out_mask, size), _small(placed, size), caption


def batches(concept_list, mapping, seed, batch, length, count, size=512):
    """The first `count` batches: {'images' (B, H, W, 3), 'masks'
    (B, h, w, 1), 'prompts'}; `length` is the dataset's enlarged length."""
    rng = random.Random(seed)
    rows = items(concept_list, mapping, rng)
    order = np.arange(length)
    np.random.default_rng(seed).shuffle(order)
    out = []
    for b in range(count):
        imgs, masks, prompts = [], [], []
        for idx in order[b * batch:(b + 1) * batch]:
            path, cap, mpath = rows[int(idx) % len(rows)]
            a, m, _, c = transform(Image.open(path).convert('RGB'),
                                   Image.open(mpath).convert('L'), cap, rng,
                                   size)
            imgs.append(a)
            masks.append(m[..., None])
            prompts.append(c)
        out.append({'images': np.stack(imgs), 'masks': np.stack(masks),
                    'prompts': prompts})
    return out
