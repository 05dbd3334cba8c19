"""Regional sampling as the regional CLI runs a layout file: one layout
(a global prompt, region prompts in boxes, a keypose condition image),
`images_per_request` images a request through
`RegionallyT2IAdapterPipeline.__call__(..., output_type='uint8')`, a
closed loop with one client.

Mix parameters: `layout` (a layout file under bench_port/, the shell
assignments the repository's layout files hold), `pose` (its keypose
image), `keypose_weight`, `images_per_request`, `steps`,
`guidance_scale`, `trace_requests`. The canvas is the pose image's size.
Each request's latents are drawn on the card from its own stream of the
seed; the layout is the same for every seed.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from bench_port import build, flops, weights
from bench_port.reference import sd15, text
from bench_port.traffic import edlora_sample

HERE = Path(__file__).resolve().parent.parent
LATENT_STREAM = 1000


def read_layout(path):
    """(global prompt, global negative, [(region prompt, negative, box in
    pixels (top, left, bottom, right))]) of a layout file."""
    kv = dict(re.findall(r"^(\w+)='(.*)'\s*$", Path(path).read_text(), re.M))
    n = len([k for k in kv if re.fullmatch(r'char\d+', k)])
    regions = [(kv[f'char{i}'], kv['context_neg_prompt'],
                [int(v) for v in re.findall(r'-?\d+', kv[f'box{i}'])])
               for i in range(1, n + 1)]
    return kv['context_prompt'], kv['context_neg_prompt'], regions


def grid_boxes(boxes, h, w):
    """Normalized (top, left, bottom, right) boxes -> pixel bounds at an
    h×w grid: ceil on the start, floor on the end, in float32."""
    b = np.asarray(boxes, np.float32).reshape(-1, 4) * np.asarray(
        [h, w, h, w], np.float32)
    return np.concatenate([np.ceil(b[:, :2]), np.floor(b[:, 2:])],
                          1).astype(np.int64)


class Workload(edlora_sample.Workload):
    """The ED-LoRA sampling driver's window, check and work accounting over
    regional requests of `rows` images."""

    def __init__(self, cfg, mix, seed, device, control=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.prompt, self.negative, self.regions = read_layout(
            HERE / mix['layout'])
        self.pose = Image.open(HERE / mix['pose']).convert('RGB')
        self.width, self.height = self.pose.size
        self.h, self.w = self.height // 8, self.width // 8
        self.rows = mix['images_per_request']
        # the regional CLI's normalized boxes: pixels over the canvas
        self.boxes = [[b[0] / self.height, b[1] / self.width,
                       b[2] / self.height, b[3] / self.width]
                      for _, _, b in self.regions]
        self.outputs, self.final = {}, {}
        self.pipe = None

    def latents(self, i):
        return torch.randn((self.rows, 4, self.h, self.w),
                           generator=weights.generator(
                               self.device, self.seed, LATENT_STREAM + i),
                           device=self.device, dtype=torch.float32)

    # ----------------------------------------------------------- program
    def setup(self, dtype=torch.bfloat16, warm=True):
        from mixofshow_tpu_torch.pipelines import RegionallyT2IAdapterPipeline
        s = build.program(self.cfg, self.seed, self.device, dtype)
        self.pipe = RegionallyT2IAdapterPipeline(
            s.unet, s.text_encoder, s.vae, s.tokenizer, self.device,
            dtype, new_concept_cfg=s.new_concept_cfg,
            concept_embedding=s.concept_table, keypose_adapter=s.adapter,
            quantize=self.quantize())
        self.keep_final()
        if warm:   # every shape of the cell, once
            self.finish(self.start(-1))
            self.outputs.clear()
            self.final.clear()

    def start(self, i):
        self.current = i
        m = self.mix
        layout = [(self.prompt, [(p, neg, box) for (p, neg, _), box in
                                 zip(self.regions, self.boxes)])]
        out = self.pipe(layout, keypose_adapter_input=self.pose,
                        keypose_adaptor_weight=m['keypose_weight'],
                        height=self.height, width=self.width,
                        num_inference_steps=m['steps'],
                        guidance_scale=m['guidance_scale'],
                        negative_prompt=self.negative,
                        num_images_per_prompt=self.rows,
                        latents=self.latents(i), output_type='uint8')
        return i, out

    def finish(self, started):
        i, out = started
        self.outputs[i] = out
        return self.rows if self.well_formed(out) else 0

    # ------------------------------------------------------------- work
    def _cross_pixels(self, hh, ww):
        """Pixels attending to a text context at an hh×ww grid: all of them
        to the global one, each box's to its region's."""
        px = grid_boxes(self.boxes, hh, ww)
        inside = sum(max(0, b[2] - b[0]) * max(0, b[3] - b[1]) for b in px)
        return hh * ww + inside

    def model_flops(self):
        u = self.cfg['unet']
        rows = 2 * self.rows if self.mix['guidance_scale'] > 1 else self.rows
        f = self.mix['steps'] * flops.unet_forward(
            u, self.h, self.w, rows, cross_pixels=self._cross_pixels)
        f += flops.vae_decode(self.cfg['vae'], self.h, self.w, self.rows)
        f += flops.adapter(self.cfg['adapter'], self.height, self.width)
        nr = len(self.regions)
        f += flops.clip_text(self.cfg['text_encoder'],
                             (1 + nr) * (build.NUM_LAYERS + 1))
        return f

    # ------------------------------------------------------- reference
    def reference_latents(self, ref, i):
        """The denoised fp32 latents of request i."""
        m = self.mix
        names, ids = ref.new_concept_cfg, ref.tokenizer
        nl = build.NUM_LAYERS

        def encode(prompts):
            return ref.text_encoder(torch.from_numpy(
                text.tokenize(prompts, ids)).to(self.device),
                ref.concept_table)

        def both(prompt, negative):
            """(2, 16, 77, C): the negative over every layer, then the
            layer-wise prompt."""
            pos = encode(text.layer_prompts(prompt, names))
            neg = encode([negative]).expand(nl, -1, -1)
            return torch.stack([neg, pos])

        ctx = both(self.prompt, self.negative)
        region_ctx = [both(p, neg) for p, neg, _ in self.regions]
        feats = ref.adapter(torch.from_numpy(
            np.asarray(self.pose, np.float32) / 255.0).permute(
                2, 0, 1)[None].to(self.device))
        feats = [f * m['keypose_weight'] for f in feats]
        n = self.rows
        feats = [torch.cat([f.repeat(n, 1, 1, 1)] * 2) for f in feats]
        ctx_rows = ctx.repeat_interleave(n, 0)
        region_rows = [c.repeat_interleave(n, 0) for c in region_ctx]
        heads = self.cfg['unet']['attention_heads']
        unet = ref.unet

        def cross(idx):
            def blend(attn2, a, hw):
                b, s, c = a.shape
                d = c // heads
                q = sd15.lin(a, attn2.to_q).view(b, s, heads, d)

                def att(context):
                    k = sd15.lin(context[:, idx], attn2.to_k).view(
                        b, -1, heads, d)
                    v = sd15.lin(context[:, idx], attn2.to_v).view(
                        b, -1, heads, d)
                    return sd15.attention(q, k, v)

                out = att(ctx_rows)
                acc = torch.zeros_like(out)
                cnt = torch.zeros(s, device=a.device)
                for rc, box in zip(region_rows,
                                   grid_boxes(self.boxes, *hw)):
                    mask = torch.zeros(hw, device=a.device)
                    mask[box[0]:box[2], box[1]:box[3]] = 1.0
                    mask = mask.reshape(-1)
                    acc += mask[None, :, None, None] * att(rc)
                    cnt += mask
                inside = (cnt > 0)[None, :, None, None]
                out = torch.where(inside, acc / cnt.clamp(min=1.0)[
                    None, :, None, None], out)
                return sd15.lin(out.reshape(b, s, c), attn2.to_out)
            return blend

        g = m['guidance_scale']

        def eps_fn(x, t):
            e = unet(torch.cat([x, x]), t, ctx_rows, adapter=feats,
                     cross=cross)
            eu, ec = e.chunk(2)
            return eu + g * (ec - eu)

        return sd15.DPMSolver(m['steps']).sample(self.latents(i), eps_fn)
