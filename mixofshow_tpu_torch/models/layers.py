"""Building blocks over torch modules (port of mixofshow_tpu/models/layers.py).

Conventions:
  * conv activations are (B, C, H, W): NCHW in the VAE and the adapter,
    channels-last inside the UNet eval (models.unet); conv weights OIHW
    (channels-last in the UNet); Linear weights (out, in);
  * a LoRA leaf is {'down': (r, in), 'up': (out, r)} (the reference's
    LoRALinearLayer layout), applied as y += alpha * up(down(x)) in the
    activation dtype (fp32 trainable leaves are cast on the way, as the JAX
    package casts them); LoRA trees are nested dicts threaded to the call
    sites, as in the JAX package;
  * norms compute their statistics in fp32 whatever the activation dtype,
    and apply a folded per-channel scale/bias in the activation dtype;
  * a Linear or Conv2d that ops.quant.quantize_unet quantized carries int8
    `wq` and fp32 `wscale` buffers; `dense` and `conv2d` route on them to
    the int8 product (the serving modes), the LoRA delta on top.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mixofshow_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_supported)
from mixofshow_tpu_torch.ops.quant import int8_conv, int8_matmul


# ----------------------------------------------------------------- dense/conv
def _lora_delta(x, lora, alpha):
    return alpha * F.linear(F.linear(x, lora['down'].to(x.dtype)),
                            lora['up'].to(x.dtype))


def dense(x: torch.Tensor, lin: nn.Linear, lora=None, alpha: float = 1.0):
    """y = x Wᵀ + b, plus the optional LoRA delta; a quantized layer's
    product is int8 (ops.quant.int8_matmul), its bias added after."""
    wq = lin._buffers.get('wq')
    if wq is None:
        y = F.linear(x, lin.weight, lin.bias)
    else:
        y = int8_matmul(x, wq, lin.wscale)
        if lin.bias is not None:
            y = y + lin.bias.to(x.dtype)
    if lora is not None:
        y = y + _lora_delta(x, lora, alpha)
    return y


def conv2d(x: torch.Tensor, conv: nn.Conv2d, lora=None, alpha: float = 1.0):
    """(B, C, H, W) conv with the module's own stride/padding; the output
    keeps x's memory layout. LoRA applies to 1x1 convs as a per-pixel dense
    delta. A quantized conv runs ops.quant.int8_conv, its bias added after.
    `conv2d.layouts` counts the calls by x's layout ('channels_last' or
    'other').

    On the CPU, where the port is held to the JAX package and to its own
    data-parallel runs, a channels-last conv runs on NCHW copies and hands
    its output on channels-last: oneDNN's NHWC kernels sum in another
    order, two to four times further from float64 than its NCHW ones at
    batch > 1, and are no faster at the tests' sizes."""
    cl = x.is_contiguous(memory_format=torch.channels_last)
    layout = 'channels_last' if cl else 'other'
    conv2d.layouts[layout] = conv2d.layouts.get(layout, 0) + 1
    weight = conv.weight
    # an x of both layouts (C or H·W of 1) hands y on as NCHW
    back = cl and x.is_cpu and not x.is_contiguous()
    if cl and x.is_cpu:
        x, weight = x.contiguous(), weight.contiguous()
    wq = conv._buffers.get('wq')
    if wq is None:
        y = F.conv2d(x, weight, conv.bias, conv.stride, conv.padding,
                     conv.dilation, conv.groups)
    else:
        y = int8_conv(x, wq, conv.wscale, conv.stride, conv.padding)
        if conv.bias is not None:
            y = y + conv.bias.to(x.dtype)[:, None, None]
    if lora is not None:
        r = lora['down'].shape[0]
        down = lora['down'].to(x.dtype).reshape(r, -1, 1, 1)
        up = lora['up'].to(x.dtype).reshape(-1, r, 1, 1)
        y = y + alpha * F.conv2d(F.conv2d(x, down), up)
    return y.contiguous(memory_format=torch.channels_last) if back else y


conv2d.layouts = {}


# ----------------------------------------------------------------------- norm
def _onepass_sums(x):
    """Per-(batch, channel) fp32 (sum, sum of squares) over H×W; the square
    runs in the input dtype with an fp32 accumulator (JAX 'onepass'). On
    the CPU a channels-last x is summed from an NCHW copy, in the order the
    CPU path keeps (see `conv2d`)."""
    if x.is_cpu:
        x = x.contiguous()
    s = torch.sum(x, dim=(2, 3), dtype=torch.float32)
    s2 = torch.sum(x * x, dim=(2, 3), dtype=torch.float32)
    return s, s2


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, act: Optional[str] = None,
               stats: str = 'onepass'):
    """GroupNorm over NCHW with fp32 one-pass statistics.

    Var = E[x²] − E[x]², clamped at 0, from fp32 accumulators; the affine is
    folded into per-(batch, channel) a, b in fp32 and applied in the
    activation dtype. `stats='kernel'` (the VAE's route) takes the sums from
    ops.gn_stats.spatial_sums (K2) and applies a, b and the SiLU in one pass
    of ops.gn_stats.scale_bias_act (K8, its SiLU in fp32); 'onepass' does
    both in plain torch (the UNet's route, as in the JAX package)."""
    b, c, h, w = x.shape
    g = norm.num_groups
    if stats == 'kernel':
        from mixofshow_tpu_torch.ops.gn_stats import (scale_bias_act,
                                                      spatial_sums)
        s, s2 = spatial_sums(x)
    elif stats == 'onepass':
        s, s2 = _onepass_sums(x)
    else:
        raise ValueError(f'unknown GroupNorm stats route {stats!r}')
    mean_g = s.reshape(b, g, c // g).mean(-1) / (h * w)
    m2_g = s2.reshape(b, g, c // g).mean(-1) / (h * w)
    mean_c = mean_g.repeat_interleave(c // g, dim=-1)
    var_g = torch.clamp(m2_g - mean_g * mean_g, min=0.0)
    rstd_c = torch.rsqrt(var_g + norm.eps).repeat_interleave(c // g, dim=-1)
    a = norm.weight.float()[None, :] * rstd_c
    bb = norm.bias.float()[None, :] - mean_c * a
    if stats == 'kernel':
        return scale_bias_act(x, a, bb, act or 'none')
    out = x * a.to(x.dtype)[:, :, None, None] \
        + bb.to(x.dtype)[:, :, None, None]
    if act == 'silu':
        out = F.silu(out)
    return out


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm):
    """LayerNorm over the last axis: fp32 statistics, activation-dtype
    apply."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + norm.eps)
    a = norm.weight.float() * rstd
    bb = norm.bias.float() - mean * a
    return x * a.to(x.dtype) + bb.to(x.dtype)


# ------------------------------------------------------------------ attention
def sdpa(q, k, v, causal: bool = False, return_probs: bool = False):
    """Multi-head scaled dot-product attention, (B, S, H, D) layout.

    Routing follows the JAX package's `sdpa`: large unmasked attention
    (`flash_attention_supported`: >= 1024 keys, >= 128 queries, D <= 160)
    goes to the differentiable flash attention (ops.flash_attention, K4-K6
    on the card); probability capture, causal masks and short contexts
    (cross-attention's 77 keys, CLIP, self-attention below 1024 keys) take
    the dense path: fp32 logits and softmax, the probabilities cast to v's
    dtype for the value product. With `return_probs` it returns (out, fp32
    probabilities (B, H, Sq, Sk))."""
    if not causal and not return_probs and flash_attention_supported(
            q.shape[1], k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(qlen, klen, dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), v)
    return (out, probs) if return_probs else out


# ------------------------------------------------------------------ timesteps
def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000):
    """Sinusoidal embedding, SD convention (cos first, shift 0), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


# ----------------------------------------------------------------------- init
@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from `generator`, in place, with the
    JAX package's distributions: Linear/Conv weight and bias U[±1/√fan_in],
    norms ones/zeros, embeddings N(0, 0.02). Values are drawn in fp32 on the
    generator's device and cast to each parameter's dtype."""
    def uniform(p, bound):
        t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        p.copy_(t.uniform_(-bound, bound, generator=generator))

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform(m.weight, bound)
            if m.bias is not None:
                uniform(m.bias, bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            t = torch.empty(m.weight.shape, dtype=torch.float32,
                            device=m.weight.device)
            m.weight.copy_(t.normal_(0.0, 0.02, generator=generator))
    return module
