"""SD1.x UNet2DConditionModel forward as a torch module.

NCHW at its boundary, channels-last inside: the eval's activations and
every conv weight are `torch.channels_last` from conv_in to conv_out, so
cuDNN runs each convolution on its NHWC kernels with no transposes, and a
transformer's (B, HW, C) tokens are views of its input map. `forward`
takes any layout and returns contiguous NCHW for the solver and the VAE,
whose K8 walks NCHW planes.

Port of mixofshow_tpu/models/unet.py. ED-LoRA specifics:
  * every cross-attention layer has a static index in down→mid→up order (16
    for SD1.5); a 4-D (B, 16, 77, C) context gives each layer its own slice;
  * LoRA is a nested dict mirroring this module tree, threaded to every
    attention linear;
  * `cross_attention_kv` projects every layer's text K/V once per sampling
    call (they are constant across the denoise steps);
  * regional sampling hands in T2I-Adapter `adapter_features` (added to the
    down blocks as diffusers 0.19.x does) and a `cross_attn_override` that
    replaces every cross-attention;
  * training asks for the cross-attention probabilities
    (`return_cross_probs`, optionally only the concept columns
    `prob_columns`) for the attention regularizer, and may recompute each
    transformer in the backward (`remat`); an attention controller asks for
    those of the layers `cross_layer_query_sizes` picks (a set of layer
    indices);
  * gradient fusion asks for the fp32 input Grams of the spatial linears
    (`capture_grams`: DEFAULT_GRAM_POINTS, ALL_GRAM_POINTS or a tuple of
    point names), per cross-attention layer index.

Attention routing follows the JAX package's `fuse_attention`:
  * 'packed' (the sampling pipelines): self-attention with >= 1024 keys runs
    the forward-only K1 processor (ops.fused_attention.attention_packed,
    LoRA folded into the effective weights);
  * False (training, the default): every attention goes through
    `layers.sdpa`, whose large self-attentions take the differentiable
    flash attention (K4-K6) and the rest the dense path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mixofshow_tpu_torch.models.layers import (conv2d, dense, group_norm,
                                               layer_norm, sdpa,
                                               timestep_embedding)
from mixofshow_tpu_torch.models.lora import maybe
from mixofshow_tpu_torch.ops.fused_attention import attention_packed
from mixofshow_tpu_torch.ops.solve import gram

PACKED_MIN_KEYS = 1024  # self-attention at or above this many keys -> K1

# Gram capture points of the fusion's spatial phase, the reference's full
# candidate list (gradient_fusion.py:637-641): attn1.*, attn2 q/out,
# ff.net.*, proj_in/proj_out. attn2's k/v inputs are text features, the
# cross-KV phase's. The ff and proj points only when a delta carries them
# (ff grams are (4c, 4c)).
DEFAULT_GRAM_POINTS = ('attn1_qkv', 'attn1_out', 'attn2_q', 'attn2_out')
ALL_GRAM_POINTS = DEFAULT_GRAM_POINTS + ('ff_in', 'ff_out', 'proj_in',
                                         'proj_out')


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


def cross_layer_query_sizes(cfg: UNetConfig, h: int, w: int):
    """(place, layer_idx, query count) of every cross-attention layer at
    latent size (h, w), in layer order; callers keep the small maps (the
    reference's <= 32² inference store, ptp_util.py:74-77)."""
    sizes = []
    idx = 0
    ch, cw = h, w
    for i, has_cross in enumerate(cfg.down_cross):
        if has_cross:
            for _ in range(cfg.layers_per_block):
                sizes.append(('down', idx, ch * cw))
                idx += 1
        if i < len(cfg.block_out_channels) - 1:
            ch, cw = -(-ch // 2), -(-cw // 2)  # stride-2 conv, padding 1
    sizes.append(('mid', idx, ch * cw))
    idx += 1
    for i, has_cross in enumerate(cfg.up_cross):
        if has_cross:
            for _ in range(cfg.layers_per_block + 1):
                sizes.append(('up', idx, ch * cw))
                idx += 1
        if i < len(cfg.block_out_channels) - 1:
            ch, cw = ch * 2, cw * 2
    return sizes


# ------------------------------------------------------------------ modules
@torch.no_grad()
def channels_last_convs(module: nn.Module, _incompatible_keys=None) -> None:
    """Lay every Conv2d weight of `module` out channels-last on a 16-byte
    boundary, in place: a weight laid out otherwise, or a view off that
    boundary (as tensors carved out of one flat buffer can be), is copied.
    cuDNN's NHWC kernels read 16-byte vectors; off the boundary a conv falls
    back to its generic `precomputed_convolve_sgemm`. Also a
    load_state_dict post hook."""
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        w = m.weight.data
        if not w.is_contiguous(memory_format=torch.channels_last) \
                or w.data_ptr() % 16:
            m.weight.data = torch.empty_like(
                w, memory_format=torch.channels_last).copy_(w)


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
                 alpha: float = 1.0, kv=None, fuse=False,
                 return_probs: bool = False, return_pre_out: bool = False):
    """diffusers `Attention` equivalent; (B, S, C) in and out. `kv` supplies
    precomputed (B, Sk, H, D) key/value projections; `fuse='packed'` routes
    >= 1024 keys to K1 unless the projections are quantized (ops.quant: the
    int8 projections then run through `dense` and the core through `sdpa`,
    as the JAX package routes a quantized layer); `return_probs` returns
    (out, fp32 probabilities);
    `return_pre_out` returns (out, the to_out layer's (B, S, C) input)."""
    if fuse not in (False, 'packed'):
        raise ValueError(f"fuse_attention must be False or 'packed', got "
                         f'{fuse!r}')
    b, s, c = x.shape
    d = c // heads
    if fuse == 'packed' and kv is None and not return_probs \
            and not return_pre_out and context.shape[1] >= PACKED_MIN_KEYS \
            and 'wq' not in p.to_q._buffers:
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
    if return_probs:
        out, probs = sdpa(q, k, v, return_probs=True)
        return dense(out.reshape(b, s, c), p.to_out, maybe(lora, 'to_out'),
                     alpha), probs
    pre = sdpa(q, k, v).reshape(b, s, c)
    out = dense(pre, p.to_out, maybe(lora, 'to_out'), alpha)
    return (out, pre) if return_pre_out else out


class FeedForward(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.proj = nn.Linear(c, 8 * c, **kw)   # GEGLU: value and gate
        self.out = nn.Linear(4 * c, c, **kw)

    def forward(self, x, lora=None, alpha=1.0, return_inner: bool = False):
        h, gate = dense(x, self.proj, maybe(lora, 'proj'), alpha).chunk(2, -1)
        # exact (erf) gelu, as diffusers' GEGLU
        inner = h * F.gelu(gate)
        out = dense(inner, self.out, maybe(lora, 'out'), alpha)
        return (out, inner) if return_inner else out


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
                cross_attn_override=None, fuse_attention=False,
                return_probs: bool = False, prob_columns=None,
                gram_points=()):
        """Returns (out, cross-attention probabilities or None, {point: fp32
        Gram} for each of `gram_points`).
        `cross_attn_override(attn2, x, ctx, layer_idx, place, (h, w), lora,
        alpha)` replaces the cross-attention when given; `return_probs`
        captures the cross-attention's fp32 probabilities (B, heads, Q, 77),
        gathered to the (B, K) key columns `prob_columns` when given, so
        full maps never stay alive for the backward."""
        b, c, h, w = x.shape
        grams = {}

        def tokens(t):  # (B, C, H, W) -> (B, HW, C), the JAX package's
            # NHWC rows: a view of a channels-last map
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

        gn_out = group_norm(x, self.norm)
        if 'proj_in' in gram_points:
            grams['proj_in'] = gram(tokens(gn_out))
        hid = tokens(conv2d(gn_out, self.proj_in, maybe(lora, 'proj_in'),
                            alpha))
        a = layer_norm(hid, self.ln1)
        if 'attn1_qkv' in gram_points:
            grams['attn1_qkv'] = gram(a)
        if 'attn1_out' in gram_points:
            sa, pre = mh_attention(self.attn1, a, a, heads,
                                   maybe(lora, 'attn1'), alpha,
                                   return_pre_out=True)
            grams['attn1_out'] = gram(pre)
        else:
            sa = mh_attention(self.attn1, a, a, heads, maybe(lora, 'attn1'),
                              alpha, fuse=fuse_attention)
        hid = hid + sa
        ctx = context[:, layer_idx] if context.dim() == 4 else context
        a = layer_norm(hid, self.ln2)
        if 'attn2_q' in gram_points:
            grams['attn2_q'] = gram(a)
        probs = None
        if cross_attn_override is not None:
            ca = cross_attn_override(self.attn2, a, ctx, layer_idx, place,
                                     (h, w), maybe(lora, 'attn2'), alpha)
        elif return_probs:
            ca, probs = mh_attention(self.attn2, a, ctx, heads,
                                     maybe(lora, 'attn2'), alpha,
                                     kv=cross_kv, return_probs=True)
            if prob_columns is not None:
                cols = prob_columns[:, None, None, :].expand(
                    *probs.shape[:3], prob_columns.shape[-1])
                probs = probs.gather(-1, cols)
        elif 'attn2_out' in gram_points:
            ca, pre = mh_attention(self.attn2, a, ctx, heads,
                                   maybe(lora, 'attn2'), alpha, kv=cross_kv,
                                   return_pre_out=True)
            grams['attn2_out'] = gram(pre)
        else:
            ca = mh_attention(self.attn2, a, ctx, heads, maybe(lora, 'attn2'),
                              alpha, kv=cross_kv, fuse=fuse_attention)
        hid = hid + ca
        a = layer_norm(hid, self.ln3)
        if 'ff_in' in gram_points:
            grams['ff_in'] = gram(a)
        if 'ff_out' in gram_points:
            ff, inner = self.ff(a, maybe(lora, 'ff'), alpha, return_inner=True)
            grams['ff_out'] = gram(inner)
        else:
            ff = self.ff(a, maybe(lora, 'ff'), alpha)
        hid = hid + ff
        if 'proj_out' in gram_points:
            grams['proj_out'] = gram(hid)
        hid = hid.reshape(b, h, w, c).permute(0, 3, 1, 2)  # channels-last
        out = conv2d(hid, self.proj_out, maybe(lora, 'proj_out'), alpha) + x
        return out, probs, grams


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
    # the JAX parameter tree's key order (init_unet inserts up_blocks before
    # mid); init_lora_tree draws in it
    JAX_CHILD_ORDER = ('conv_in', 'time_embedding', 'down_blocks',
                       'up_blocks', 'mid', 'norm_out', 'conv_out')

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
        # once here, never per call: under a channels-last input a weight
        # left NCHW is transposed at every call. copy_-loads keep the
        # strides and the alignment; a load that assigns tensors gets them
        # laid out again
        channels_last_convs(self)
        self.register_load_state_dict_post_hook(channels_last_convs)

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
                adapter_features=None, cross_attn_override=None,
                fuse_attention=False, return_cross_probs=False,
                prob_columns=None, remat: bool = False,
                capture_grams=False):
        """Predict noise. sample (B, 4, h, w), any layout (made
        channels-last here); timesteps (B,) or a scalar;
        encoder_hidden_states (B, 77, C) or layerwise (B, 16, 77, C);
        `cross_kv` from `cross_attention_kv`; `adapter_features` (B, C, H,
        W) maps, one per down block (T2IAdapter; channels-last, or each
        add reads across the layout); `cross_attn_override` replaces
        every cross-attention (see Transformer.forward); `fuse_attention`
        False or 'packed' (see the module docstring); `remat` recomputes
        each transformer in the backward (torch.utils.checkpoint);
        `capture_grams` True (DEFAULT_GRAM_POINTS) or a tuple of points;
        `return_cross_probs` True (every cross-attention layer) or a set of
        layer indices (only those build a map).

        Returns the prediction (contiguous NCHW), or with
        `return_cross_probs` or `capture_grams` (prediction, aux):
        aux['cross_probs'] lists (place, layer_idx, probs (B, heads, Q, 77
        or K)) in layer order
        (`prob_columns` (B, K) keeps only those key columns);
        aux['grams'] maps each layer_idx to {point: (F, F) fp32 Gram}."""
        cfg = self.cfg
        points = DEFAULT_GRAM_POINTS if capture_grams is True \
            else tuple(capture_grams or ())
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

        probs_out = []
        grams_out = {}

        def tfm(mod, x, blora, place):
            nonlocal idx
            kv = None if cross_kv is None else cross_kv[idx]
            probs_here = return_cross_probs is True or (
                bool(return_cross_probs) and idx in return_cross_probs)
            args = (x, ehs, idx, heads, blora, lora_alpha, kv, place,
                    cross_attn_override, fuse_attention, probs_here,
                    prob_columns, points)
            if remat:
                out, probs, grams = torch.utils.checkpoint.checkpoint(
                    mod, *args, use_reentrant=False)
            else:
                out, probs, grams = mod(*args)
            if probs is not None:
                probs_out.append((place, idx, probs))
            if grams:
                grams_out[idx] = grams
            idx += 1
            return out

        x = conv2d(sample.contiguous(memory_format=torch.channels_last),
                   self.conv_in)
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
        out = conv2d(x, self.conv_out).contiguous()
        aux = {}
        if return_cross_probs:
            aux['cross_probs'] = probs_out
        if points:
            aux['grams'] = grams_out
        return (out, aux) if aux else out
