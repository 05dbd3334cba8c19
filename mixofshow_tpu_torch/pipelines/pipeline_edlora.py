"""EDLoRAPipeline: single/multi-concept text-to-image sampling.

Port of mixofshow_tpu/pipelines/pipeline_edlora.py (plain sampling, the
attention-controller path and the int8 serving modes; data-parallel sweeps
split their batches over processes, pipelines/validation.py). One call:
  1. expands concept tokens into 16 layerwise prompts and tokenizes on the
     host;
  2. CLIP-encodes them, [uncond; cond] order;
  3. projects every cross-attention K/V once (the contexts are constant
     across the steps);
  4. runs the CFG denoise loop: the UNet in the compute dtype (bf16 by
     default) on the concatenated batch, the DPM-Solver++ update on fp32
     latents;
  5. VAE-decodes and converts to uint8 on the device.
Only `output_type` conversion (and `PendingSample.result`) waits for the
device, so `submit()` returns while the work is still queued.

With a controller attached (`set_controller`, a utils.ptp.AttentionStore)
the UNet also returns the fp32 cross-attention probabilities of the layers
with at most `controller.max_size`² queries; they are summed over the steps
on the device and handed to `controller.store_summed` once after the loop,
as the JAX package's scan carries them. The 77-key cross-attention takes
the same dense route with or without capture, so the images do not change.

`quantize='int8'` or `'int8+conv'` is the JAX package's opt-in serving
mode (ops/quant.py): the UNet's transformer dense pool (and with '+conv'
its resnet convs) runs int8 products with dynamic activation scales,
quantized from the weights after their cast to `dtype`, as the JAX
pipeline quantizes its cast tree. A quantized attn1 leaves the packed K1
route: its projections run int8 and its core goes through `sdpa` (K4, the
flash kernel, at 1024 keys and more). The quantization lives on the shared
UNet module, so the pipeline built last over a UNet sets its mode; calling
an earlier pipeline whose mode it changed raises.

Noise: with `latents=None` the initial noise comes from a torch.Generator on
the pipeline's device seeded with `seed`; it differs from the JAX
package's noise for the same seed. Pass `latents` to reproduce a JAX run.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from mixofshow_tpu_torch.diffusion import DPMSolverMultistep
from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
from mixofshow_tpu_torch.models.lora import map_lora
from mixofshow_tpu_torch.models.unet import cross_layer_query_sizes
from mixofshow_tpu_torch.ops.quant import set_quantization
from mixofshow_tpu_torch.pipelines.concepts import (NUM_CROSS_ATTENTION_LAYERS,
                                                    bind_concept_prompt)
from mixofshow_tpu_torch.text.tokenizer import CLIPTokenizer
from mixofshow_tpu_torch.utils.device import COMPUTE_DTYPE, as_device
from mixofshow_tpu_torch.utils.profiling import last_request, span

OUTPUT_TYPES = ('pil', 'uint8', 'np', 'latent')


class EDLoRAPipeline:
    """Sampling pipeline over the port's modules.

    The modules are moved to `device` and cast to `dtype` IN PLACE (a copy of
    an SD1.5 UNet would double its memory). Unmerged LoRA trees (`unet_lora`,
    `text_lora`, nested dicts of {'down', 'up'} tensors) apply on the fly
    with `lora_alpha`. `quantize` (None, 'int8' or 'int8+conv') sets the
    UNet's serving mode after the cast; any other value raises
    ValueError."""

    def __init__(self, unet: UNet, text_encoder: CLIPTextModel,
                 vae: AutoencoderKL, tokenizer: CLIPTokenizer, device,
                 dtype: torch.dtype = COMPUTE_DTYPE,
                 scheduler: Optional[DPMSolverMultistep] = None,
                 new_concept_cfg: Optional[Dict] = None,
                 concept_embedding=None,
                 unet_lora=None, text_lora=None, lora_alpha: float = 1.0,
                 quantize: Optional[str] = None):
        self.device = as_device(device)
        self.dtype = dtype
        self.unet = unet.to(device=self.device, dtype=dtype).eval()
        set_quantization(self.unet, quantize)
        self.quantize = quantize
        self.text_encoder = text_encoder.to(device=self.device,
                                            dtype=dtype).eval()
        self.vae = vae.to(device=self.device, dtype=dtype).eval()
        self.tokenizer = tokenizer
        self.scheduler = scheduler or DPMSolverMultistep.create()
        self.new_concept_cfg = new_concept_cfg
        self.concept_embedding = None if concept_embedding is None else \
            self._on_device(concept_embedding)
        self.unet_lora = map_lora(unet_lora, self._on_device)
        self.text_lora = map_lora(text_lora, self._on_device)
        self.lora_alpha = lora_alpha
        self.controller = None

    def _on_device(self, t):
        return torch.as_tensor(t).to(device=self.device, dtype=self.dtype)

    def set_new_concept_cfg(self, new_concept_cfg: Optional[Dict] = None):
        self.new_concept_cfg = new_concept_cfg

    def set_controller(self, controller):
        """Attach an attention controller (utils.ptp.AttentionStore) that is
        fed the cross-attention maps of each sampling call (reference
        set_controller, pipeline_edlora.py:107); a controller with a
        `step_callback(latents)` is also called after every step with the
        NCHW fp32 latents on the device, and what it returns (unless None)
        replaces them. None detaches."""
        self.controller = controller

    def _capture_layers(self, h: int, w: int):
        """The controller's layers at latent size (h, w): those with at most
        max_size² queries, as (place, layer_idx)."""
        if self.controller is None:
            return ()
        top = self.controller.max_size ** 2
        return tuple((place, idx) for place, idx, q in
                     cross_layer_query_sizes(self.unet.cfg, h, w)
                     if q <= top)

    # ------------------------------------------------------------ encoding
    def _encode_texts(self, texts):
        ids = torch.from_numpy(self.tokenizer(texts).astype(np.int64))
        if self.device.type == 'cuda':
            # a pageable host->device copy waits for all queued work; from
            # pinned memory it is queued like a kernel (submit() relies on it)
            ids = ids.pin_memory()
        return self.text_encoder(ids.to(self.device, non_blocking=True),
                                 self.concept_embedding, self.text_lora,
                                 self.lora_alpha)

    @torch.inference_mode()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      negative_prompt: Optional[Union[str, Sequence[str]]]
                      = None, do_cfg: bool = True) -> torch.Tensor:
        """(2B or B, 16, 77, C) prompt embeddings, [uncond; cond] order; the
        negative prompt is encoded once and broadcast over the 16 layers."""
        if self.new_concept_cfg is None:
            raise ValueError('set_new_concept_cfg first')
        with span('encode', self.device):
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            b = len(prompts)
            emb = self._encode_texts(bind_concept_prompt(prompts,
                                                         self.new_concept_cfg))
            emb = emb.reshape(b, NUM_CROSS_ATTENTION_LAYERS, *emb.shape[1:])
            if not do_cfg:
                return emb
            if negative_prompt is None:
                neg = [''] * b
            elif isinstance(negative_prompt, str):
                neg = [negative_prompt] * b
            else:
                neg = list(negative_prompt)
                if len(neg) != b:
                    raise ValueError('negative_prompt batch mismatch')
            nemb = self._encode_texts(neg)[:, None].expand(
                b, NUM_CROSS_ATTENTION_LAYERS, *emb.shape[2:])
            return torch.cat([nemb, emb])

    # ------------------------------------------------------------ sampling
    def _initial_latents(self, latents, b, h, w, seed):
        if latents is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            return torch.randn((b, 4, h, w), generator=g, device=self.device,
                               dtype=torch.float32)
        lat = torch.as_tensor(latents).to(device=self.device,
                                          dtype=torch.float32)
        if lat.dim() == 4 and not (lat.shape[1] == 4 and lat.shape[-1] != 4):
            lat = lat.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        return lat

    def _denoise(self, embeds, lat, guidance_scale, num_inference_steps,
                 do_cfg, callback=None, callback_steps=1, capture=(),
                 **unet_kw):
        """The CFG denoise loop; `unet_kw` goes to every UNet eval. Returns
        the final latents and {(place, layer_idx): fp32 probabilities
        summed over the steps} of the `capture` layers."""
        if self.unet.quantize_mode != self.quantize:
            raise RuntimeError(
                f'this pipeline serves quantize={self.quantize!r} but its '
                f'UNet was set to {self.unet.quantize_mode!r} by a pipeline '
                f'built after it')
        with span('denoise', self.device):
            solver = self.scheduler
            coeffs = solver.step_coeffs(num_inference_steps)
            lora, alpha = self.unet_lora, self.lora_alpha
            layers = frozenset(idx for _, idx in capture)
            step_callback = getattr(self.controller, 'step_callback', None)
            sample, m_prev = lat, torch.zeros_like(lat)
            psum = {}
            for i in range(len(coeffs.timestep)):
                t = int(coeffs.timestep[i])
                with span('unet', self.device):
                    latent_in = torch.cat([sample, sample]) if do_cfg \
                        else sample
                    ts = torch.full((latent_in.shape[0],), t,
                                    device=self.device)
                    eps = self.unet(latent_in.to(self.dtype), ts, embeds,
                                    lora, alpha, fuse_attention='packed',
                                    return_cross_probs=layers, **unet_kw)
                if layers:
                    eps, aux = eps
                    for place, idx, probs in aux['cross_probs']:
                        if (place, idx) in psum:
                            psum[(place, idx)].add_(probs)
                        else:
                            psum[(place, idx)] = probs.float().clone()
                with span('solver', self.device):
                    eps = eps.float()
                    if do_cfg:
                        eps_u, eps_c = eps.chunk(2)
                        eps = eps_u + guidance_scale * (eps_c - eps_u)
                    sample, m_prev = solver.step(sample, m_prev, eps, coeffs,
                                                 i)
                if step_callback is not None:
                    stepped = step_callback(sample)
                    if stepped is not None:
                        sample = torch.as_tensor(stepped).to(sample)
                if callback is not None and i % callback_steps == 0:
                    callback(i, t, sample)
            return sample, psum

    def _feed_controller(self, psum, num_inference_steps: int):
        """Hand the summed maps to the controller, in (place, layer_idx)
        order, as numpy on the host (one wait for the device)."""
        if self.controller is not None:
            self.controller.store_summed(
                [(place, idx, m.cpu().numpy())
                 for (place, idx), m in sorted(psum.items())],
                num_inference_steps)

    def _decode(self, final, output_type: str):
        """Device-side output: latents, float NHWC images in [0, 1], or
        uint8 NHWC pixels."""
        if output_type == 'latent':
            return final
        with span('decode', self.device):
            lat = final.to(self.dtype) / self.vae.cfg.scaling_factor
            img = torch.clamp(self.vae.decode(lat) * 0.5 + 0.5, 0.0, 1.0)
            img = img.permute(0, 2, 3, 1)
            if output_type == 'np':
                return img.float()
            return torch.round(img.float() * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def _sample_on_device(self, prompt=None, height=512, width=512,
                          num_inference_steps=50, guidance_scale=7.5,
                          negative_prompt=None, num_images_per_prompt=1,
                          latents=None, prompt_embeds=None, callback=None,
                          callback_steps=1, seed=0, output_type='pil'):
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f'output_type must be one of {OUTPUT_TYPES}')
        with span('request', self.device, root=True):
            do_cfg = guidance_scale > 1.0
            if prompt_embeds is not None:
                embeds = torch.as_tensor(prompt_embeds).to(self.device)
                b = embeds.shape[0] // 2 if do_cfg else embeds.shape[0]
            else:
                b = 1 if isinstance(prompt, str) else len(prompt)
                embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
            if num_images_per_prompt > 1:
                n = num_images_per_prompt
                if do_cfg:
                    neg, pos = embeds.chunk(2)
                    embeds = torch.cat([neg.repeat_interleave(n, 0),
                                        pos.repeat_interleave(n, 0)])
                else:
                    embeds = embeds.repeat_interleave(n, 0)
                b *= n
            lat = self._initial_latents(
                latents, b, height // 8, width // 8,
                seed) * self.scheduler.init_noise_sigma()
            embeds = embeds.to(self.dtype)
            ckv = self.unet.cross_attention_kv(embeds, self.unet_lora,
                                               self.lora_alpha)
            final, psum = self._denoise(
                embeds, lat, guidance_scale, num_inference_steps, do_cfg,
                callback, callback_steps,
                self._capture_layers(height // 8, width // 8), cross_kv=ckv)
            out = self._decode(final, output_type)
            self._feed_controller(psum, num_inference_steps)
            return out

    def __call__(self,
                 prompt: Union[str, Sequence[str]] = None,
                 height: int = 512,
                 width: int = 512,
                 num_inference_steps: int = 50,
                 guidance_scale: float = 7.5,
                 negative_prompt: Optional[Union[str, Sequence[str]]] = None,
                 num_images_per_prompt: int = 1,
                 latents=None,
                 prompt_embeds=None,
                 callback=None,
                 callback_steps: int = 1,
                 seed: int = 0,
                 output_type: str = 'pil'):
        """Sample images: a list of PIL images ('pil', the default), a
        (B, H, W, 3) uint8 array ('uint8'), a (B, H, W, 3) float32 array in
        [0, 1] ('np'), or (B, 4, h, w) fp32 latents ('latent').

        `latents` takes external noise, NCHW (B, 4, h, w) or NHWC.
        `prompt_embeds` bypasses encoding with (2B or B, 16, 77, C)
        embeddings. `callback(i, t, latents)` runs every `callback_steps`
        steps with the NCHW fp32 latents on the device. An attached
        controller receives the call's cross-attention maps
        (`set_controller`)."""
        out = self._sample_on_device(
            prompt, height, width, num_inference_steps, guidance_scale,
            negative_prompt, num_images_per_prompt, latents, prompt_embeds,
            callback, callback_steps, seed, output_type)
        return _to_host(out, output_type, last_request())

    def submit(self, *args, output_type: str = 'pil', **kwargs
               ) -> 'PendingSample':
        """Queue a whole sampling call (the arguments of `__call__`) on the
        device without waiting for it; `PendingSample.result()` waits and
        converts. Queuing the next call before reading the previous result
        overlaps host-side tokenization and conversion with device work."""
        if kwargs.get('callback') is not None:
            raise ValueError('submit() takes no callback (it would sync)')
        if self.controller is not None:
            raise ValueError('submit() with a controller would sync; use '
                             '__call__')
        out = self._sample_on_device(*args, output_type=output_type,
                                     **kwargs)
        return PendingSample(out, output_type)


def _to_host(out: torch.Tensor, output_type: str, request: Optional[int]):
    """The device output on the host (waits for the card), inside the
    `result` span of the sampling call with ordinal `request`."""
    with span('result', out.device, request=request):
        arr = out.cpu().numpy()
        if output_type == 'pil':
            from PIL import Image
            return [Image.fromarray(x) for x in arr]
        return arr


class PendingSample:
    """A queued sampling call (`EDLoRAPipeline.submit`); `result()` waits
    for the device and converts. It carries the ordinal of the call's
    `request` span to its `result` span."""

    def __init__(self, device_out: torch.Tensor, output_type: str):
        self._dev = device_out
        self._output_type = output_type
        self._request = last_request()

    def result(self):
        return _to_host(self._dev, self._output_type, self._request)
