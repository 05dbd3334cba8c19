"""ED-LoRA sampling as validation sweeps and `test_edlora` run it: requests
of `rows_per_request` (prompt, latent) rows through
`EDLoRAPipeline.submit(..., output_type='uint8')`, one request queued
ahead of the one being read back (pipelines/validation.visual_validation's
loop), a closed loop with one client.

Mix parameters: `prompts` (a file under bench_port/), `replace` (the
concept mapping of `<TOK>`), `negative_prompt`, `rows_per_request`,
`height`, `width`, `steps`, `guidance_scale`, `lora_alpha`,
`trace_requests`. Row r of the run is prompt (seed + r) mod n, so every
seed sends the same sizes in another order; each request's latents are
drawn on the card from its own stream of the seed.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from bench_port import build, check, flops, weights
from bench_port.reference import sd15, text

HERE = Path(__file__).resolve().parent.parent
LATENT_STREAM = 1000


def read_prompts(mix):
    lines = (HERE / mix['prompts']).read_text().splitlines()
    out = []
    for line in lines:
        if not line.strip():
            continue
        for k, v in mix.get('replace', {}).items():
            line = line.replace(k, v)
        out.append(re.sub(' +', ' ', line.strip()))
    return out


class Workload:
    CONTROLS = ('int8', 'int8+conv', 'reference_fp8')

    def __init__(self, cfg, mix, seed, device, control=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.prompts = read_prompts(mix)
        self.rows = mix['rows_per_request']
        self.height, self.width = mix['height'], mix['width']
        self.h, self.w = self.height // 8, self.width // 8
        self.outputs, self.final = {}, {}
        self.pipe = None

    # ------------------------------------------------------------ inputs
    def request(self, i):
        """(prompts, latents (rows, 4, h, w) fp32 on the card) of request
        i."""
        n = len(self.prompts)
        prompts = [self.prompts[(self.seed + self.rows * i + r) % n]
                   for r in range(self.rows)]
        lat = torch.randn((self.rows, 4, self.h, self.w),
                          generator=weights.generator(
                              self.device, self.seed, LATENT_STREAM + i),
                          device=self.device, dtype=torch.float32)
        return prompts, lat

    # ----------------------------------------------------------- program
    def setup(self, dtype=torch.bfloat16, warm=True):
        from mixofshow_tpu_torch.pipelines import EDLoRAPipeline
        s = build.program(self.cfg, self.seed, self.device, dtype)
        self.pipe = EDLoRAPipeline(
            s.unet, s.text_encoder, s.vae, s.tokenizer, self.device,
            dtype, new_concept_cfg=s.new_concept_cfg,
            concept_embedding=s.concept_table, unet_lora=s.unet_lora,
            text_lora=s.text_lora, lora_alpha=self.mix['lora_alpha'],
            quantize=self.quantize())
        self.keep_final()
        if warm:   # every shape of the cell, once
            self.finish(self.start(-1))
            self.outputs.clear()
            self.final.clear()

    def quantize(self):
        return self.control if self.control in ('int8', 'int8+conv') \
            else None

    def keep_final(self):
        """Keep, by request, the fp32 latents the pipeline hands to its
        decode: a reference to a tensor the program made, no copy, no
        wait."""
        decode = self.pipe._decode

        def keep(final, output_type):
            self.final[self.current] = final
            return decode(final, output_type)
        self.pipe._decode = keep

    def start(self, i):
        self.current = i
        prompts, lat = self.request(i)
        m = self.mix
        handle = self.pipe.submit(
            prompts, height=m['height'], width=m['width'],
            num_inference_steps=m['steps'],
            guidance_scale=m['guidance_scale'],
            negative_prompt=[m['negative_prompt']] * len(prompts),
            latents=lat, output_type='uint8')
        return i, handle

    def finish(self, started):
        i, handle = started
        out = handle.result()
        self.outputs[i] = out
        return self.rows if self.well_formed(out) else 0

    def well_formed(self, out):
        return out.shape == (self.rows, self.height, self.width, 3) and \
            out.dtype == np.uint8

    def wait(self):
        """Nothing: `finish` waits for each request."""

    def close_program(self):
        self.pipe = None

    def close(self):
        """Nothing written to close."""

    def reference_gaps(self, seed, device, done, k):
        """Latent and image gaps of k of the finished requests, drawn from
        the seed."""
        requests = check.sample(done, k, seed)
        if self.control == 'reference_fp8':
            self.plant_fp8(device, requests)
        return check.image_gaps(self, seed, device, requests)

    @torch.inference_mode()
    def plant_fp8(self, device, requests):
        """The reference with float8 operands in the program's place: its
        latents and images of `requests`."""
        sd15.exact_fp32()
        ref = build.reference(self.cfg, self.seed, device)
        for mod in (ref.unet, ref.text_encoder, ref.vae, ref.adapter):
            if mod is not None:
                sd15.to_fp8_(mod)
        for i in requests:
            self.final[i] = self.reference_latents(ref, i)
            self.outputs[i] = self.decode(ref.vae, self.final[i])

    # ------------------------------------------------------------- work
    def model_flops(self):
        """Model FLOPs of one request."""
        u = self.cfg['unet']
        rows = 2 * self.rows if self.mix['guidance_scale'] > 1 else self.rows
        f = self.mix['steps'] * flops.unet_forward(u, self.h, self.w, rows)
        f += flops.vae_decode(self.cfg['vae'], self.h, self.w, self.rows)
        f += flops.clip_text(self.cfg['text_encoder'],
                             self.rows * (build.NUM_LAYERS + 1))
        return f

    def attention_work(self):
        """[(flops, bytes)] of one request's UNet self-attention at 1024
        tokens or more and its VAE mid-block attention."""
        u = self.cfg['unet']
        rows = 2 * self.rows if self.mix['guidance_scale'] > 1 else self.rows
        work = self.mix['steps'] * flops.self_attention_work(
            u, self.h, self.w, rows, 1024)
        return work + [flops.vae_mid_attention_work(self.cfg['vae'], self.h,
                                                    self.w, self.rows)]

    # ------------------------------------------------------- reference
    def decode(self, vae, x):
        return sd15.decode_uint8(vae, x, self.cfg['vae']['scaling_factor'])

    def reference_latents(self, ref, i):
        """The denoised fp32 latents of request i."""
        prompts, lat = self.request(i)
        m = self.mix
        names, ids = ref.new_concept_cfg, ref.tokenizer
        layered = [p for pr in prompts for p in text.layer_prompts(pr, names)]
        ctx = ref.text_encoder(
            torch.from_numpy(text.tokenize(layered, ids)).to(self.device),
            ref.concept_table, ref.text_lora, m['lora_alpha'])
        ctx = ctx.view(len(prompts), build.NUM_LAYERS, *ctx.shape[1:])
        neg = ref.text_encoder(
            torch.from_numpy(text.tokenize([m['negative_prompt']] *
                                           len(prompts), ids)).to(
                self.device), ref.concept_table, ref.text_lora,
            m['lora_alpha'])
        neg = neg[:, None].expand_as(ctx)
        both = torch.cat([neg, ctx])
        g = m['guidance_scale']

        def eps_fn(x, t):
            e = ref.unet(torch.cat([x, x]), t, both, ref.unet_lora,
                         m['lora_alpha'])
            eu, ec = e.chunk(2)
            return eu + g * (ec - eu)

        return sd15.DPMSolver(m['steps']).sample(lat, eps_fn)
