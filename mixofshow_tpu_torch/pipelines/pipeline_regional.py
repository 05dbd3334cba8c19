"""Regionally controllable multi-concept sampling with T2I-Adapter control.

Port of mixofshow_tpu/pipelines/pipeline_regional.py (the reference
`RegionallyT2IAdapterPipeline`): a global prompt plus per-region (box)
prompts. Inside each box the cross-attention output is recomputed against
that region's context; keypose and sketch adapter features, weighted
globally and per region, are added to the UNet's down blocks. One call:
  1. encodes the (1+R) layerwise prompts and (1+R) negatives in one batched
     CLIP call, memoized on the layout text;
  2. runs the adapters once and weights their features by the region maps;
  3. projects the global and per-region cross K/V once;
  4. runs the CFG denoise loop, every cross-attention through the region
     override (K7, ops/region_attention.py);
  5. VAE-decodes as EDLoRAPipeline does.

Routing inside the override is a shape rule, decided before any launch:
with regions that `region_attention_supported` takes, the attention core is
`region_attention` between the plain to_q and to_out projections; with no
regions, the dense 77-key `sdpa` (which the JAX package leaves to XLA); with
regions the kernel does not take (more than 16, heads wider than 160, more
than 128 keys), the JAX package's XLA path in plain torch on the tensors'
device: a global `sdpa`, one `sdpa` per region, and the overlap-counted mean
inside the boxes.

Noise: with `latents=None` the initial noise comes from a torch.Generator
seeded with `seed`, which differs from the JAX package's noise; pass
`latents` to reproduce a JAX run.
"""
from __future__ import annotations

import ast
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from mixofshow_tpu_torch.models.layers import dense, sdpa
from mixofshow_tpu_torch.models.lora import maybe
from mixofshow_tpu_torch.models.t2i_adapter import (T2IAdapter,
                                                    preprocess_adapter_image)
from mixofshow_tpu_torch.ops.region_attention import (
    boxes_to_grid, region_attention, region_attention_supported,
    region_blend)
from mixofshow_tpu_torch.pipelines.concepts import (NUM_CROSS_ATTENTION_LAYERS,
                                                    bind_concept_prompt)
from mixofshow_tpu_torch.pipelines.pipeline_edlora import (OUTPUT_TYPES,
                                                           EDLoRAPipeline,
                                                           _to_host)
from mixofshow_tpu_torch.utils.device import COMPUTE_DTYPE
from mixofshow_tpu_torch.utils.profiling import last_request, span


def _repeat_cfg(embeds, n: int, use_cfg: bool):
    """Repeat (2B or B, 16, 77, C) embeddings n times per image, keeping the
    [uncond; cond] halves grouped."""
    if not use_cfg:
        return embeds.repeat_interleave(n, 0)
    neg, pos = embeds.chunk(2)
    return torch.cat([neg.repeat_interleave(n, 0),
                      pos.repeat_interleave(n, 0)])


def _stack_region_kv(tables):
    """[{layer: (k, v)}] per region -> {layer: (r_k, r_v)}, each (R, B, Sk,
    H, D)."""
    return {idx: tuple(torch.stack([t[idx][i] for t in tables])
                       for i in (0, 1))
            for idx in tables[0]}


def make_region_override(boxes, heads: int, kv_table, region_kv_tables):
    """The cross-attention override of regional sampling, for
    UNet.forward(cross_attn_override=...).

    boxes: one normalized (start_h, start_w, end_h, end_w) box per region.
    `kv_table` and `region_kv_tables` ({layer_idx: (k, v)} from
    UNet.cross_attention_kv, one table per region) hold the K/V of the
    global and per-region contexts, projected once per sampling call (they
    are constant across the steps). Boxes are rasterized once per grid
    size."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    region_kv = _stack_region_kv(region_kv_tables) if len(boxes) else {}
    grids = {}

    def override(attn2, x, ctx, layer_idx, place, hw, lora, alpha):
        b, n, c = x.shape
        d = c // heads
        q = dense(x, attn2.to_q, maybe(lora, 'to_q'), alpha).view(
            b, n, heads, d)
        k, v = (t.to(x.dtype) for t in kv_table[layer_idx])
        if not len(boxes):
            out = sdpa(q, k, v)
        else:
            rk, rv = (t.to(x.dtype) for t in region_kv[layer_idx])
            if hw not in grids:
                grids[hw] = boxes_to_grid(boxes, *hw)
            if region_attention_supported(heads, d, k.shape[1], len(boxes)):
                out = region_attention(q, k, v, rk, rv, grids[hw], hw)
            else:
                out = region_blend(sdpa, q, k, v, rk, rv, grids[hw], hw)
        return dense(out.reshape(b, n, c), attn2.to_out,
                     maybe(lora, 'to_out'), alpha)

    return override


def parse_region_weight_spec(spec: str, height: int, width: int,
                             feat_h: int, feat_w: int,
                             base_weight: float) -> np.ndarray:
    """'[sh, sw, eh, ew]-weight|...' (pixel coords) -> (feat_h, feat_w)
    float32 weight map, parsed with ast.literal_eval."""
    wmap = np.full((feat_h, feat_w), base_weight, np.float32)
    if not spec:
        return wmap
    for region_weight in spec.split('|'):
        region, weight = region_weight.rsplit('-', 1)
        sh, sw, eh, ew = ast.literal_eval(region)
        weight = float(ast.literal_eval(weight))
        sh = math.ceil(sh / height * feat_h)
        sw = math.ceil(sw / width * feat_w)
        eh = math.floor(eh / height * feat_h)
        ew = math.floor(ew / width * feat_w)
        wmap[sh:eh, sw:ew] = weight
    return wmap


class RegionallyT2IAdapterPipeline(EDLoRAPipeline):
    """Multi-concept regional sampling over a fused checkpoint (concept rows
    inside the text encoder's vocab table; an unfused `concept_embedding`
    table works too).

    `prompt` is [(context_prompt, [(region_prompt, region_negative_prompt,
    box), ...])] with normalized (start_h, start_w, end_h, end_w) boxes. The
    modules and adapters move to `device` and `dtype` in place. `quantize`
    is EDLoRAPipeline's: the region override's projections run through
    `layers.dense`, so they take the int8 route too, as in the JAX
    package."""

    def __init__(self, unet, text_encoder, vae, tokenizer, device,
                 dtype: torch.dtype = COMPUTE_DTYPE, scheduler=None,
                 new_concept_cfg=None, concept_embedding=None,
                 keypose_adapter: Optional[T2IAdapter] = None,
                 sketch_adapter: Optional[T2IAdapter] = None,
                 quantize: Optional[str] = None):
        super().__init__(unet, text_encoder, vae, tokenizer, device, dtype,
                         scheduler, new_concept_cfg, concept_embedding,
                         quantize=quantize)
        self.keypose_adapter, self.sketch_adapter = (
            None if a is None else a.to(device=self.device, dtype=dtype).eval()
            for a in (keypose_adapter, sketch_adapter))
        self._encode_memo = None  # (layout key, encoded), see below

    def set_new_concept_cfg(self, new_concept_cfg=None):
        super().set_new_concept_cfg(new_concept_cfg)
        self._encode_memo = None  # the binding depends on the concept cfg

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor in the compute dtype, queued like a
        kernel (pinned memory) rather than waiting for queued work."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self.device.type == 'cuda':
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True).to(self.dtype)

    # ------------------------------------------------------------ encoding
    @torch.inference_mode()
    def encode_region_prompt(self, prompt, negative_prompt: str = ''):
        """-> (prompt_embeds (2, 16, 77, C), [(embeds (2, 16, 77, C), box
        float32 (4,)), ...]), each [negative; layerwise] in that order.

        All (1+R) layerwise prompts and (1+R) negatives go through ONE
        batched CLIP call. The result is memoized on the layout text (one
        layout, many seeds is the serving pattern), so a repeat call skips
        encoding; any text change, or `set_new_concept_cfg`, re-encodes."""
        if self.new_concept_cfg is None:
            raise ValueError('set_new_concept_cfg first')
        if len(prompt) != 1:
            raise ValueError('one layout prompt per call')
        with span('encode', self.device):
            key = (repr(prompt), negative_prompt or '')
            if self._encode_memo is not None and self._encode_memo[0] == key:
                return self._encode_memo[1]
            context_prompt, regions = prompt[0]
            nl = NUM_CROSS_ATTENTION_LAYERS
            texts = []
            for p in [context_prompt] + [r[0] for r in regions]:
                texts.extend(bind_concept_prompt([p], self.new_concept_cfg))
            texts.append(negative_prompt or '')
            texts.extend(r[1] or '' for r in regions)
            emb = self._encode_texts(texts)

            n_lw = 1 + len(regions)
            lw = emb[:n_lw * nl].reshape(n_lw, nl, *emb.shape[1:])

            def with_neg(i, pos):  # the plain negative over the 16 layers
                neg = emb[n_lw * nl + i][None, None].expand(1, nl,
                                                            *emb.shape[1:])
                return torch.cat([neg, pos[None]]).to(self.dtype)

            prompt_embeds = with_neg(0, lw[0])
            region_list = [(with_neg(1 + i, lw[1 + i]),
                            np.asarray(box, np.float32))
                           for i, (_, _, box) in enumerate(regions)]
            self._encode_memo = (key, (prompt_embeds, region_list))
            return prompt_embeds, region_list

    # ------------------------------------------------------------ adapters
    @torch.inference_mode()
    def _adapter_features(self, keypose_input, keypose_weight,
                          region_keypose_weight, sketch_input, sketch_weight,
                          region_sketch_weight, height, width, use_cfg,
                          num_images: int = 1):
        """Keypose plus sketch features, each weighted by its map, tiled to
        `num_images` and doubled for CFG: (B, C, H, W) channels-last, the
        UNet's layout, one per down block."""
        with span('adapter', self.device):
            states = []
            for name, adapter, inp, weight, spec in (
                    ('keypose', self.keypose_adapter, keypose_input,
                     keypose_weight, region_keypose_weight),
                    ('sketch', self.sketch_adapter, sketch_input,
                     sketch_weight, region_sketch_weight)):
                if inp is None:
                    continue
                if adapter is None:
                    raise ValueError(f'a {name} input needs a {name} adapter')
                feats = adapter(self._upload(inp.transpose(0, 3, 1, 2)))
                states.append((feats, weight, spec))
            if not states:
                return None
            merged = []
            for idx in range(len(states[0][0])):
                total = None
                for feats, weight, spec in states:
                    f = feats[idx]
                    wmap = parse_region_weight_spec(spec, height, width,
                                                    f.shape[2], f.shape[3],
                                                    float(weight))
                    f = f * self._upload(wmap)[None, None]
                    total = f if total is None else total + f
                total = total.repeat_interleave(num_images, 0)
                if use_cfg:
                    total = torch.cat([total, total])
                merged.append(total.contiguous(
                    memory_format=torch.channels_last))
            return merged

    # ------------------------------------------------------------ sampling
    @torch.inference_mode()
    def _sample_on_device(self, prompt=None,
                          keypose_adapter_input=None,
                          keypose_adaptor_weight: float = 1.0,
                          region_keypose_adaptor_weight: str = '',
                          sketch_adapter_input=None,
                          sketch_adaptor_weight: float = 1.0,
                          region_sketch_adaptor_weight: str = '',
                          height: int = 512,
                          width: int = 512,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 7.5,
                          negative_prompt: Optional[Union[str, Sequence[str]]]
                          = None,
                          num_images_per_prompt: int = 1,
                          latents=None,
                          seed: int = 0,
                          output_type: str = 'pil'):
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f'output_type must be one of {OUTPUT_TYPES}')
        if self.controller is not None:
            raise ValueError('regional sampling takes no attention '
                             'controller (the JAX package\'s has none)')
        with span('request', self.device, root=True):
            use_cfg = guidance_scale > 1.0
            n = int(num_images_per_prompt)
            neg = negative_prompt[0] if isinstance(negative_prompt,
                                                   (list, tuple)) else \
                (negative_prompt or '')
            prompt_embeds, region_list = self.encode_region_prompt(prompt, neg)
            if not use_cfg:  # keep the layerwise (cond) half only
                prompt_embeds = prompt_embeds[1:]
                region_list = [(e[1:], box) for e, box in region_list]
            prompt_embeds = _repeat_cfg(prompt_embeds, n, use_cfg)
            region_list = [(_repeat_cfg(e, n, use_cfg), box)
                           for e, box in region_list]

            keypose, sketch = (None if img is None else
                               preprocess_adapter_image(img, height, width)
                               for img in (keypose_adapter_input,
                                           sketch_adapter_input))
            adapter_features = self._adapter_features(
                keypose, keypose_adaptor_weight, region_keypose_adaptor_weight,
                sketch, sketch_adaptor_weight, region_sketch_adaptor_weight,
                height, width, use_cfg, num_images=n)

            lat = self._initial_latents(
                latents, n, height // 8, width // 8,
                seed) * self.scheduler.init_noise_sigma()
            override = make_region_override(
                [box for _, box in region_list], self.unet.cfg.attention_heads,
                self.unet.cross_attention_kv(prompt_embeds),
                [self.unet.cross_attention_kv(e) for e, _ in region_list])
            final, _ = self._denoise(prompt_embeds, lat, guidance_scale,
                                     num_inference_steps, use_cfg,
                                     adapter_features=adapter_features,
                                     cross_attn_override=override)
            return self._decode(final, output_type)

    def __call__(self, *args, output_type: str = 'pil', **kwargs):
        """Sample `num_images_per_prompt` images of one regional layout.

        Arguments (see `_sample_on_device`): `prompt` as in the class
        docstring; `keypose_adapter_input` / `sketch_adapter_input` (PIL
        images or NHWC arrays in [0, 1]) with global weights
        `keypose_adaptor_weight` / `sketch_adaptor_weight` and per-region
        '[sh, sw, eh, ew]-weight|...' specs in pixels
        (`region_keypose_adaptor_weight`, `region_sketch_adaptor_weight`);
        `height`, `width`, `num_inference_steps`, `guidance_scale`,
        `negative_prompt`, `num_images_per_prompt`, `latents` (NCHW or
        NHWC), `seed`. Returns PIL images ('pil'), (N, H, W, 3) uint8
        ('uint8'), float32 in [0, 1] ('np') or (N, 4, h, w) latents
        ('latent'). `submit` takes the same arguments without waiting."""
        out = self._sample_on_device(*args, output_type=output_type,
                                     **kwargs)
        return _to_host(out, output_type, last_request())
