"""SD1.x UNet2DConditionModel forward as a torch module, NCHW.

Port of mixofshow_tpu/models/unet.py for sampling (no probability or Gram
capture yet). ED-LoRA specifics:
  * every cross-attention layer has a static index in down→mid→up order (16
    for SD1.5); a 4-D (B, 16, 77, C) context gives each layer its own slice;
  * LoRA is a nested dict mirroring this module tree, threaded to every
    attention linear;
  * `cross_attention_kv` projects every layer's text K/V once per sampling
    call (they are constant across the denoise steps);
  * regional sampling hands in T2I-Adapter `adapter_features` (added to the
    down blocks as diffusers 0.19.x does) and a `cross_attn_override` that
    replaces every cross-attention.

Attention routing follows the JAX package: self-attention with >= 1024 keys
runs the K1 processor (ops.fused_attention.attention_packed, LoRA folded into
the effective weights); shorter and cross-attention run the dense `sdpa`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mixofshow_tpu_torch.models.layers import (conv2d, dense, group_norm,
                                               layer_norm, sdpa,
                                               timestep_embedding)
from mixofshow_tpu_torch.models.lora import maybe
from mixofshow_tpu_torch.ops.fused_attention import attention_packed

PACKED_MIN_KEYS = 1024  # self-attention at or above this many keys -> K1


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8  # SD1.x: attention_head_dim config == num heads
    norm_groups: int = 32
    sample_size: int = 64
    down_cross: Tuple[bool, ...] = (True, True, True, False)

    @staticmethod
    def sd15() -> 'UNetConfig':
        return UNetConfig()

    @staticmethod
    def tiny() -> 'UNetConfig':
        """Small config for tests: same topology, 10x fewer channels."""
        return UNetConfig(block_out_channels=(32, 64, 128, 128),
                          cross_attention_dim=64, attention_heads=2,
                          norm_groups=8, sample_size=16)

    @property
    def up_cross(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_cross))


def cross_layer_paths(cfg: UNetConfig):
    """Module path of each cross-attention transformer in layer-index order
    (down→mid→up)."""
    paths = []
    for i, has_cross in enumerate(cfg.down_cross):
        if has_cross:
            paths += [f'down_blocks/{i}/attentions/{j}'
                      for j in range(cfg.layers_per_block)]
    paths.append('mid/attention')
    for i, has_cross in enumerate(cfg.up_cross):
        if has_cross:
            paths += [f'up_blocks/{i}/attentions/{j}'
                      for j in range(cfg.layers_per_block + 1)]
    return paths


# ------------------------------------------------------------------ modules
class Resnet(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, **kw)
        self.time_emb_proj = nn.Linear(temb_dim, cout, **kw)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, **kw)
        self.shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x, temb_act):
        h = conv2d(group_norm(x, self.norm1, act='silu'), self.conv1)
        h = h + dense(temb_act, self.time_emb_proj)[:, :, None, None]
        h = conv2d(group_norm(h, self.norm2, act='silu'), self.conv2)
        if self.shortcut is not None:
            x = conv2d(x, self.shortcut)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim, context_dim, **kw):
        super().__init__()
        self.to_q = nn.Linear(query_dim, query_dim, bias=False, **kw)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False, **kw)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False, **kw)
        self.to_out = nn.Linear(query_dim, query_dim, **kw)


def mh_attention(p: Attention, x, context, heads: int, lora=None,
                 alpha: float = 1.0, kv=None):
    """diffusers `Attention` equivalent; (B, S, C) in and out. `kv` supplies
    precomputed (B, Sk, H, D) key/value projections."""
    b, s, c = x.shape
    d = c // heads
    if kv is None and context.shape[1] >= PACKED_MIN_KEYS:
        def eff(name):
            w = getattr(p, name).weight
            lw = maybe(lora, name)
            if lw is not None:
                w = w + alpha * (lw['up'] @ lw['down']).to(w.dtype)
            return w
        return attention_packed(x, context, eff('to_q'), eff('to_k'),
                                eff('to_v'), eff('to_out'), p.to_out.bias,
                                heads)
    q = dense(x, p.to_q, maybe(lora, 'to_q'), alpha).view(b, s, heads, d)
    if kv is None:
        k = dense(context, p.to_k, maybe(lora, 'to_k'), alpha)
        v = dense(context, p.to_v, maybe(lora, 'to_v'), alpha)
        k, v = k.view(b, -1, heads, d), v.view(b, -1, heads, d)
    else:
        k, v = kv[0].to(x.dtype), kv[1].to(x.dtype)
    out = sdpa(q, k, v).reshape(b, s, c)
    return dense(out, p.to_out, maybe(lora, 'to_out'), alpha)


class FeedForward(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.proj = nn.Linear(c, 8 * c, **kw)   # GEGLU: value and gate
        self.out = nn.Linear(4 * c, c, **kw)

    def forward(self, x, lora=None, alpha=1.0):
        h, gate = dense(x, self.proj, maybe(lora, 'proj'), alpha).chunk(2, -1)
        # exact (erf) gelu, as diffusers' GEGLU
        return dense(h * F.gelu(gate), self.out, maybe(lora, 'out'), alpha)


class Transformer(nn.Module):
    """Transformer2DModel with one BasicTransformerBlock (SD1.x shape)."""

    def __init__(self, c, context_dim, groups, **kw):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6, **kw)
        self.proj_in = nn.Conv2d(c, c, 1, **kw)
        self.ln1 = nn.LayerNorm(c, **kw)
        self.attn1 = Attention(c, c, **kw)
        self.ln2 = nn.LayerNorm(c, **kw)
        self.attn2 = Attention(c, context_dim, **kw)
        self.ln3 = nn.LayerNorm(c, **kw)
        self.ff = FeedForward(c, **kw)
        self.proj_out = nn.Conv2d(c, c, 1, **kw)

    def forward(self, x, context, layer_idx: int, heads: int, lora=None,
                alpha=1.0, cross_kv=None, place: str = 'down',
                cross_attn_override=None):
        """`cross_attn_override(attn2, x, ctx, layer_idx, place, (h, w),
        lora, alpha)` replaces the cross-attention when given."""
        b, c, h, w = x.shape
        hid = conv2d(group_norm(x, self.norm), self.proj_in,
                     maybe(lora, 'proj_in'), alpha)
        hid = hid.permute(0, 2, 3, 1).reshape(b, h * w, c)
        a = layer_norm(hid, self.ln1)
        hid = hid + mh_attention(self.attn1, a, a, heads,
                                 maybe(lora, 'attn1'), alpha)
        ctx = context[:, layer_idx] if context.dim() == 4 else context
        a = layer_norm(hid, self.ln2)
        if cross_attn_override is not None:
            hid = hid + cross_attn_override(self.attn2, a, ctx, layer_idx,
                                            place, (h, w),
                                            maybe(lora, 'attn2'), alpha)
        else:
            hid = hid + mh_attention(self.attn2, a, ctx, heads,
                                     maybe(lora, 'attn2'), alpha, kv=cross_kv)
        hid = hid + self.ff(layer_norm(hid, self.ln3), maybe(lora, 'ff'),
                            alpha)
        hid = hid.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return conv2d(hid, self.proj_out, maybe(lora, 'proj_out'), alpha) + x


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, c, temb_dim, cfg: UNetConfig, **kw):
        super().__init__()
        self.resnet1 = Resnet(c, c, temb_dim, cfg.norm_groups, **kw)
        self.attention = Transformer(c, cfg.cross_attention_dim,
                                     cfg.norm_groups, **kw)
        self.resnet2 = Resnet(c, c, temb_dim, cfg.norm_groups, **kw)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ch = cfg.block_out_channels
        temb_dim = 4 * ch[0]
        g = cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.time_embedding = nn.ModuleDict({
            'linear_1': nn.Linear(ch[0], temb_dim, **kw),
            'linear_2': nn.Linear(temb_dim, temb_dim, **kw)})
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, has_cross in enumerate(cfg.down_cross):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(Resnet(cin, ch[i], temb_dim, g, **kw))
                cin = ch[i]
                if has_cross:
                    blk.attentions.append(
                        Transformer(cin, cfg.cross_attention_dim, g, **kw))
            if i < len(ch) - 1:
                blk.downsample = nn.Conv2d(cin, cin, 3, stride=2, padding=1,
                                           **kw)
            self.down_blocks.append(blk)
        self.mid = _Mid(cin, temb_dim, cfg, **kw)
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, has_cross in enumerate(cfg.up_cross):
            blk = _Block()
            skip_ch = rev[min(i + 1, len(ch) - 1)]
            for j in range(cfg.layers_per_block + 1):
                skip = rev[i] if j < cfg.layers_per_block else skip_ch
                blk.resnets.append(Resnet(cin + skip, rev[i], temb_dim, g,
                                          **kw))
                cin = rev[i]
                if has_cross:
                    blk.attentions.append(
                        Transformer(cin, cfg.cross_attention_dim, g, **kw))
            if i < len(ch) - 1:
                blk.upsample = nn.Conv2d(cin, cin, 3, padding=1, **kw)
            self.up_blocks.append(blk)
        self.norm_out = nn.GroupNorm(g, cin, eps=1e-5, **kw)
        self.conv_out = nn.Conv2d(cin, cfg.out_channels, 3, padding=1, **kw)

    def _transformers(self):
        """(path, module) of every cross-attention transformer, in
        layer-index order."""
        out = []
        for path in cross_layer_paths(self.cfg):
            mod = self
            for part in path.split('/'):
                mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
            out.append((path, mod))
        return out

    def cross_attention_kv(self, encoder_hidden_states, lora=None,
                           alpha: float = 1.0):
        """Every cross-attention layer's text K/V projections, computed once
        per sampling call: {layer_idx: (k, v)}, each (B, 77, heads, D)."""
        ehs = encoder_hidden_states
        heads = self.cfg.attention_heads
        out = {}
        for idx, (path, tfm) in enumerate(self._transformers()):
            lw = maybe(lora, *path.split('/'), 'attn2')
            ctx = ehs[:, idx] if ehs.dim() == 4 else ehs
            k = dense(ctx, tfm.attn2.to_k, maybe(lw, 'to_k'), alpha)
            v = dense(ctx, tfm.attn2.to_v, maybe(lw, 'to_v'), alpha)
            b, s, c = k.shape
            out[idx] = (k.view(b, s, heads, c // heads),
                        v.view(b, s, heads, c // heads))
        return out

    def forward(self, sample, timesteps, encoder_hidden_states, lora=None,
                lora_alpha: float = 1.0, cross_kv=None,
                adapter_features=None, cross_attn_override=None):
        """Predict noise. sample (B, 4, h, w) NCHW; timesteps (B,) or a
        scalar; encoder_hidden_states (B, 77, C) or layerwise (B, 16, 77, C);
        `cross_kv` from `cross_attention_kv`; `adapter_features` NCHW maps,
        one per down block (T2IAdapter); `cross_attn_override` replaces
        every cross-attention (see Transformer.forward)."""
        cfg = self.cfg
        dt = sample.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = dense(temb.to(dt), self.time_embedding['linear_1'])
        temb = dense(F.silu(temb), self.time_embedding['linear_2'])
        temb_act = F.silu(temb)
        ehs = encoder_hidden_states.to(dt)
        heads = cfg.attention_heads
        idx = 0

        def tfm(mod, x, blora, place):
            nonlocal idx
            kv = None if cross_kv is None else cross_kv[idx]
            out = mod(x, ehs, idx, heads, blora, lora_alpha, kv, place,
                      cross_attn_override)
            idx += 1
            return out

        x = conv2d(sample, self.conv_in)
        residuals = [x]
        for i, blk in enumerate(self.down_blocks):
            blora = maybe(lora, 'down_blocks', i)
            for j, res in enumerate(blk.resnets):
                x = res(x, temb_act)
                if cfg.down_cross[i]:
                    x = tfm(blk.attentions[j], x,
                            maybe(blora, 'attentions', j), 'down')
                residuals.append(x)
            if adapter_features is not None and i < len(adapter_features):
                # diffusers 0.19.x: in a cross-attention block the feature
                # lands on the last output, and so on its residual; after a
                # plain DownBlock2D it leaves that block's residuals alone
                x = x + adapter_features[i].to(dt)
                if cfg.down_cross[i]:
                    residuals[-1] = x
            if hasattr(blk, 'downsample'):
                x = conv2d(x, blk.downsample)
                residuals.append(x)

        x = self.mid.resnet1(x, temb_act)
        x = tfm(self.mid.attention, x, maybe(lora, 'mid', 'attention'),
                'mid')
        x = self.mid.resnet2(x, temb_act)

        for i, blk in enumerate(self.up_blocks):
            blora = maybe(lora, 'up_blocks', i)
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, residuals.pop()], dim=1), temb_act)
                if cfg.up_cross[i]:
                    x = tfm(blk.attentions[j], x,
                            maybe(blora, 'attentions', j), 'up')
            if hasattr(blk, 'upsample'):
                x = conv2d(F.interpolate(x, scale_factor=2, mode='nearest'),
                           blk.upsample)

        x = group_norm(x, self.norm_out, act='silu')
        return conv2d(x, self.conv_out)
