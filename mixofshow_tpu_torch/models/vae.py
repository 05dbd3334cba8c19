"""AutoencoderKL (SD1.x VAE) as a torch module, NCHW.

Port of mixofshow_tpu/models/vae.py.
  * Encoder (training): conv_in, four down stages of two resnets with
    diffusers' asymmetric (0, 1, 0, 1) pad before each stride-2 conv, mid
    block (resnet, one single-head attention, resnet), norm_out + SiLU,
    conv_out, then quant_conv -> (mean, logvar clipped to [-30, 20]).
  * Decoder (sampling): post_quant_conv, conv_in, mid block, four up stages
    of three resnets with nearest 2x upsampling, norm_out + SiLU, conv_out.

Routing follows the JAX package: every VAE GroupNorm takes its statistics
from the K2 kernel (ops.gn_stats.spatial_sums) and each mid-block attention
runs the whole-processor K3 kernel (ops.fused_attention.attention_block).
Both kernels are forward-only; the trainer encodes under no_grad, as the JAX
trainer stops the gradient at the latents.

The encoder and quant_conv are registered after the decoder and
post_quant_conv, so a seeded random init draws the decoder's weights exactly
as a decode-only module did.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mixofshow_tpu_torch.models.layers import conv2d, group_norm
from mixofshow_tpu_torch.ops.fused_attention import attention_block

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def sd15() -> 'VAEConfig':
        return VAEConfig()


def _gn(x, norm, act=None):
    return group_norm(x, norm, act=act, stats='kernel')


class Resnet(nn.Module):
    def __init__(self, cin, cout, groups, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=EPS, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, **kw)
        self.norm2 = nn.GroupNorm(groups, cout, eps=EPS, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, **kw)
        self.shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x):
        h = conv2d(_gn(x, self.norm1, 'silu'), self.conv1)
        h = conv2d(_gn(h, self.norm2, 'silu'), self.conv2)
        if self.shortcut is not None:
            x = conv2d(x, self.shortcut)
        return x + h


class Attn(nn.Module):
    """Mid-block attention: one head, 1x1-conv q/k/v/proj with biases."""

    def __init__(self, c, groups, **kw):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=EPS, **kw)
        self.q = nn.Conv2d(c, c, 1, **kw)
        self.k = nn.Conv2d(c, c, 1, **kw)
        self.v = nn.Conv2d(c, c, 1, **kw)
        self.proj = nn.Conv2d(c, c, 1, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = _gn(x, self.norm).flatten(2).transpose(1, 2).contiguous()

        def wt(conv):
            return conv.weight.view(c, c)

        out = attention_block(tokens, tokens, wt(self.q), wt(self.k),
                              wt(self.v), wt(self.proj), self.proj.bias, 1,
                              bias_q=self.q.bias, bias_k=self.k.bias,
                              bias_v=self.v.bias)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _Mid(nn.Module):
    def __init__(self, c, groups, **kw):
        super().__init__()
        self.resnet1 = Resnet(c, c, groups, **kw)
        self.attn = Attn(c, groups, **kw)
        self.resnet2 = Resnet(c, c, groups, **kw)


class _Stage(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_groups
        cin = ch[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, cin, 3, padding=1, **kw)
        self.mid = _Mid(cin, g, **kw)
        self.up = nn.ModuleList()
        for i, cout in enumerate(reversed(ch)):
            stage = _Stage()
            for _ in range(cfg.layers_per_block + 1):
                stage.resnets.append(Resnet(cin, cout, g, **kw))
                cin = cout
            if i < len(ch) - 1:
                stage.upsample = nn.Conv2d(cin, cin, 3, padding=1, **kw)
            self.up.append(stage)
        self.norm_out = nn.GroupNorm(g, cin, eps=EPS, **kw)
        self.conv_out = nn.Conv2d(cin, cfg.in_channels, 3, padding=1, **kw)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.down = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            stage = _Stage()
            for _ in range(cfg.layers_per_block):
                stage.resnets.append(Resnet(cin, cout, g, **kw))
                cin = cout
            if i < len(ch) - 1:
                # diffusers pads (0, 1, 0, 1) itself: no conv padding
                stage.downsample = nn.Conv2d(cin, cin, 3, stride=2, **kw)
            self.down.append(stage)
        self.mid = _Mid(cin, g, **kw)
        self.norm_out = nn.GroupNorm(g, cin, eps=EPS, **kw)
        self.conv_out = nn.Conv2d(cin, 2 * cfg.latent_channels, 3, padding=1,
                                  **kw)


class AutoencoderKL(nn.Module):
    """SD1.x VAE: `encode` for training, `decode` for sampling."""

    def __init__(self, cfg: VAEConfig, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.decoder = Decoder(cfg, **kw)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1, **kw)
        self.encoder = Encoder(cfg, **kw)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1, **kw)

    def encode(self, images):
        """images (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4,
        H/8, W/8); logvar clipped to [-30, 20]. Callers multiply the sample
        by cfg.scaling_factor."""
        e = self.encoder
        x = conv2d(images, e.conv_in)
        for stage in e.down:
            for r in stage.resnets:
                x = r(x)
            if hasattr(stage, 'downsample'):
                x = conv2d(F.pad(x, (0, 1, 0, 1)), stage.downsample)
        x = e.mid.resnet2(e.mid.attn(e.mid.resnet1(x)))
        x = conv2d(_gn(x, e.norm_out, 'silu'), e.conv_out)
        mean, logvar = conv2d(x, self.quant_conv).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, latents):
        """latents (B, 4, h, w) — the caller divides by scaling_factor
        first — -> images (B, 3, 8h, 8w) in [-1, 1]."""
        d = self.decoder
        x = conv2d(conv2d(latents, self.post_quant_conv), d.conv_in)
        x = d.mid.resnet2(d.mid.attn(d.mid.resnet1(x)))
        for stage in d.up:
            for r in stage.resnets:
                x = r(x)
            if hasattr(stage, 'upsample'):
                x = conv2d(F.interpolate(x, scale_factor=2, mode='nearest'),
                           stage.upsample)
        return conv2d(_gn(x, d.norm_out, 'silu'), d.conv_out)


def sample_latents(mean, logvar, eps):
    """The reparameterised sample mean + exp(logvar / 2) · eps; `eps` is
    standard normal noise of mean's shape, drawn by the caller."""
    return mean + torch.exp(0.5 * logvar) * eps
