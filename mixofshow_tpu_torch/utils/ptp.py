"""Prompt-to-prompt attention store and cross-attention visualization.

Port of mixofshow_tpu/utils/ptp.py (reference `mixofshow/utils/ptp_util.py`:
AttentionControl :22, AttentionStore :67, aggregate_attention :159,
show_cross_attention :176), host-side numpy, a copy that imports neither
jax nor the JAX package. The UNet returns the chosen layers'
cross-attention probabilities (`UNet.forward(return_cross_probs=...)`), and
EDLoRAPipeline sums them over the steps on the device and hands them to
`store_summed` once after the loop, so the store is a plain accumulator: no
forward patching, no per-layer counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class AttentionStore:
    """Accumulates per-step cross-attention maps grouped by UNet placement.

    Feed `store_step(aux['cross_probs'])` once per diffusion step; maps are
    running-summed across steps (reference ptp_util.py:79-98) and averaged on
    read. `max_size` skips maps larger than max_size² query pixels (the
    reference stores ≤32² in inference mode, everything in training mode,
    ptp_util.py:74-77)."""

    def __init__(self, training: bool = False,
                 max_size: Optional[int] = None):
        self.training = training
        self.max_size = max_size if max_size is not None else \
            (64 if training else 32)
        self.reset()

    def reset(self):
        self.step_store: Dict[str, List[np.ndarray]] = {}
        self.attention_store: Dict[str, List[np.ndarray]] = {}
        self.cur_step = 0

    def store_step(self, cross_probs: List[Tuple[str, int, np.ndarray]]):
        """cross_probs: [(place, layer_idx, probs (B, heads, Q, K))]."""
        self.step_store = {}
        for place, _, probs in cross_probs:
            probs = np.asarray(probs)
            q = probs.shape[-2]
            if q > self.max_size ** 2:
                continue
            key = f'{place}_cross'
            self.step_store.setdefault(key, []).append(probs)
        self._between_steps()

    def _between_steps(self):
        if not self.attention_store:
            self.attention_store = self.step_store
        else:
            for key, maps in self.step_store.items():
                for i, m in enumerate(maps):
                    self.attention_store[key][i] = \
                        self.attention_store[key][i] + m
        self.step_store = {}
        self.cur_step += 1

    def store_summed(self, cross_probs: List[Tuple[str, int, np.ndarray]],
                     num_steps: int):
        """Ingest maps already SUMMED over `num_steps` diffusion steps.

        EDLoRAPipeline keeps running sums on the device instead of handing
        over per-step maps: the same as feeding store_step once per step
        (reference ptp_util.py:79-98 sums across steps too)."""
        for place, _, probs in cross_probs:
            probs = np.asarray(probs)
            q = probs.shape[-2]
            if q > self.max_size ** 2:
                continue
            key = f'{place}_cross'
            self.step_store.setdefault(key, []).append(probs)
        if not self.attention_store:
            self.attention_store = self.step_store
        else:
            for key, maps in self.step_store.items():
                for i, m in enumerate(maps):
                    self.attention_store[key][i] = \
                        self.attention_store[key][i] + m
        self.step_store = {}
        self.cur_step += num_steps

    def get_average_attention(self) -> Dict[str, List[np.ndarray]]:
        steps = max(self.cur_step, 1)
        return {k: [m / steps for m in maps]
                for k, maps in self.attention_store.items()}


def aggregate_attention(store: AttentionStore, res: int,
                        from_where: Tuple[str, ...], select: int = 0,
                        batch_size: int = 1) -> np.ndarray:
    """Average all stored cross maps at resolution `res` over layers+heads →
    (res, res, K) (reference aggregate_attention, ptp_util.py:159-173)."""
    out = []
    num_pixels = res ** 2
    avg = store.get_average_attention()
    for place in from_where:
        for m in avg.get(f'{place}_cross', []):
            b, h, q, k = m.shape
            if q != num_pixels:
                continue
            maps = m.reshape(batch_size, -1, res, res, k)[select]
            out.append(maps)
    assert out, f'no cross maps at res {res}'
    cat = np.concatenate(out, axis=0)
    return cat.mean(axis=0)


def show_cross_attention(store: AttentionStore, res: int,
                         from_where: Tuple[str, ...], tokens: List[str],
                         select: int = 0, upscale: int = 8):
    """Per-token attention heatmap strip as a PIL image (reference
    show_cross_attention, ptp_util.py:176-200). `tokens` are the decoded
    prompt tokens to caption each tile with."""
    from PIL import Image, ImageDraw

    maps = aggregate_attention(store, res, from_where, select)
    tiles = []
    for i, tok in enumerate(tokens):
        m = maps[:, :, i]
        m = m / (m.max() + 1e-12)
        img = Image.fromarray((m * 255).astype(np.uint8)).resize(
            (res * upscale, res * upscale), Image.NEAREST).convert('RGB')
        draw = ImageDraw.Draw(img)
        draw.text((4, 4), tok, fill=(255, 64, 64))
        tiles.append(img)
    strip = Image.new('RGB', (len(tiles) * res * upscale, res * upscale))
    for i, t in enumerate(tiles):
        strip.paste(t, (i * res * upscale, 0))
    return strip
