"""Weight and activation int8 quantization for the serving dense pool.

Port of mixofshow_tpu/ops/quant.py: the opt-in serving modes of both
sampling pipelines (`quantize='int8'` and `'int8+conv'`), not part of the
reference's surface. The scheme, as the JAX package's:
  * weights: symmetric per output channel, from the weights in the compute
    dtype: wscale = max|w| / 127 + 1e-12 over the input axes (fp32), wq =
    clip(rint(w / wscale), ±127) as int8, kept in the module's own layout
    ((out, in) for nn.Linear where JAX's kernel is (in, out); OIHW for
    nn.Conv2d where JAX's is HWIO);
  * activations: dynamic, one scale a row for a dense layer and one a
    batch element (image) for a conv: sx = max|x| / 127 + 1e-12 and xq =
    clip(round(x / sx), ±127), in fp32 with round half to even, the JAX
    package's division and rounding, so that on the same inputs the int8
    activations and the int32 accumulators are JAX's bitwise;
  * int32 accumulation, then one fp32 rescale acc · (sx · wscale), then a
    cast to the activation dtype. The divisions by 127 are IEEE quotients
    on either device (`_scale`).

The products are `torch._int_mm` (cuBLASLt's int8 GEMM on the card), as the
JAX package leaves its int8 dots to XLA: no Pallas kernel is replaced, so
no hand-written kernel is owed. On the card `_int_mm` takes more than 16
rows and K, N multiples of 8: rows (and K, N where needed) are padded with
zeros, which add nothing to the accumulators. A conv is im2col
(`F.unfold` with zero padding, what JAX's padding of a quantized zero
gives) followed by the same product; the unfold runs on the quantized
values in bf16, which holds every integer in ±127 exactly.

`quantize_unet` registers int8 `wq` and fp32 `wscale` buffers (not in the
state dict) on the quantized layers, beside their weights, which stay;
`models.layers.dense` and `conv2d` route on their presence, so the LoRA
delta still applies exactly in the activation dtype on top. The sites are
the JAX package's: attn1 and attn2 `to_q/to_k/to_v/to_out` and the GEGLU
`proj/out` for 'int8', plus the resnet blocks' `conv1/conv2` for
'int8+conv'; nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MODES = (None, 'int8', 'int8+conv')
_ATTN_KEYS = ('to_q', 'to_k', 'to_v', 'to_out')
_FF_KEYS = ('proj', 'out')
_CONV_KEYS = ('conv1', 'conv2')
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 + 1e-12 in fp32 with an IEEE division: divided by a
    tensor, since CUDA divides by a Python scalar as a product with its
    reciprocal, which can differ in the last bit from JAX's and the CPU's
    quotient."""
    amax = amax.float()
    return amax / torch.full_like(amax, 127.0) + 1e-12


def quantize_activation(x: torch.Tensor, dims) -> tuple:
    """(int8 values, fp32 scale) with one scale over `dims` (kept). The
    passes read x in its own dtype; its values are exact in fp32, so the
    quotient is the fp32 one."""
    sx = _scale(x.abs().amax(dim=dims, keepdim=True))
    xq = torch.round(x / sx).clamp_(-127, 127).to(torch.int8)
    return xq, sx


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int_mm(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 a (M, K) · wq (N, K)ᵀ with `torch._int_mm`; zero padding meets
    its CUDA constraints."""
    m, k = a.shape
    n = wq.shape[0]
    if a.is_cuda:
        kp, np_ = -(-k // _ALIGN) * _ALIGN, -(-n // _ALIGN) * _ALIGN
        a = _pad_to(_pad_to(a, 0, _MIN_ROWS), 1, kp)
        wq = _pad_to(_pad_to(wq, 0, np_), 1, kp)
    return torch._int_mm(a, wq.t())[:m, :n]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                wscale: torch.Tensor) -> torch.Tensor:
    """(…, in) x int8 (out, in) -> (…, out) in x's dtype, the activation
    quantized per row; int32 accumulation, one fp32 rescale."""
    xq, sx = quantize_activation(x, -1)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    return torch.mul(acc, sx * wscale.float()).to(x.dtype)


def int_conv(xq: torch.Tensor, wq: torch.Tensor, stride=1,
             padding=0) -> torch.Tensor:
    """int32 accumulators (B, O, Ho, Wo), channels-last, of int8 (B, C, H,
    W) `xq` with int8 OIHW `wq`: im2col (zero padding), then `int_mm`."""
    b, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) \
        else tuple(padding)
    cols = F.unfold(xq.to(torch.bfloat16), (kh, kw), padding=padding,
                    stride=stride)                        # (B, C·kh·kw, L)
    ho = (h + 2 * padding[0] - kh) // stride[0] + 1
    wo = (w + 2 * padding[1] - kw) // stride[1] + 1
    a = cols.transpose(1, 2).reshape(b * ho * wo, -1).to(torch.int8)
    acc = int_mm(a, wq.reshape(o, -1)).reshape(b, ho, wo, o)
    return acc.permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
              stride=1, padding=0) -> torch.Tensor:
    """(B, C, H, W) x int8 OIHW -> channels-last (B, O, Ho, Wo) in x's
    dtype, the UNet's layout, the activation quantized per image (a conv
    mixes neighbouring pixels, so a finer scale would break the linearity
    the int32 accumulation relies on); `int_conv`, one fp32 rescale."""
    xq, sx = quantize_activation(x, (1, 2, 3))
    acc = int_conv(xq, wq, stride, padding)
    scale = sx * wscale.float().view(1, -1, 1, 1)
    return torch.mul(acc, scale).to(x.dtype)


def _quantize_weight(w: torch.Tensor, in_dims) -> tuple:
    wf = w.float()
    wscale = _scale(wf.abs().amax(dim=in_dims))
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.clamp(torch.round(wf / wscale.view(shape)), -127, 127)
    return wq.to(torch.int8), wscale


@torch.no_grad()
def quantize_dense(lin: nn.Linear) -> nn.Linear:
    """Register int8 `wq` (out, in) and fp32 `wscale` (out,) beside the
    Linear's weight."""
    wq, wscale = _quantize_weight(lin.weight, 1)
    lin.register_buffer('wq', wq, persistent=False)
    lin.register_buffer('wscale', wscale, persistent=False)
    return lin


@torch.no_grad()
def quantize_conv(conv: nn.Conv2d) -> nn.Conv2d:
    """Register int8 `wq` (OIHW, contiguous whatever the weight's layout,
    so `int_conv` reads it as (O, I·kh·kw) rows without a copy) and fp32
    `wscale` (O,) beside the conv's weight."""
    wq, wscale = _quantize_weight(conv.weight, (1, 2, 3))
    conv.register_buffer('wq', wq.contiguous(), persistent=False)
    conv.register_buffer('wscale', wscale, persistent=False)
    return conv


def quantized_sites(unet: nn.Module, convs: bool = False):
    """[(path, module)] of the layers `quantize_unet` quantizes, in module
    order: attn1/attn2's to_q/k/v/out and ff's proj/out; with `convs` the
    resnet blocks' conv1/conv2 too."""
    sites = []
    for name, m in unet.named_modules():
        last = name.rsplit('.', 1)[-1]
        if last in ('attn1', 'attn2'):
            keys = _ATTN_KEYS
        elif last == 'ff':
            keys = _FF_KEYS
        elif convs and hasattr(m, 'conv1') and hasattr(m, 'conv2'):
            keys = _CONV_KEYS
        else:
            continue
        sites += [(f'{name}.{k}', getattr(m, k)) for k in keys]
    return sites


def quantize_unet(unet: nn.Module, convs: bool = False) -> nn.Module:
    """Quantize the UNet's transformer dense pool in place, from its weights
    as they are (cast them to the compute dtype first); `convs` also the
    resnet 3x3 convs (mode 'int8+conv'). Replaces an earlier quantization."""
    dequantize(unet)
    for _, m in quantized_sites(unet, convs):
        (quantize_conv if isinstance(m, nn.Conv2d) else quantize_dense)(m)
    unet.quantize_mode = 'int8+conv' if convs else 'int8'
    return unet


def dequantize(unet: nn.Module) -> nn.Module:
    """Drop every `wq`/`wscale` buffer: the module runs its weights again."""
    for m in unet.modules():
        for key in ('wq', 'wscale'):
            m._buffers.pop(key, None)
    unet.quantize_mode = None
    return unet


def set_quantization(unet: nn.Module, mode: Optional[str]) -> nn.Module:
    """Put the UNet in serving mode `mode` (None, 'int8' or 'int8+conv');
    any other value raises ValueError."""
    if mode not in MODES:
        raise ValueError(f'unknown quantize mode: {mode!r}')
    if mode is None:
        return dequantize(unet)
    return quantize_unet(unet, convs=mode == 'int8+conv')


__all__ = ['MODES', 'dequantize', 'int8_conv', 'int8_matmul', 'int_conv',
           'int_mm', 'quantize_activation', 'quantize_conv',
           'quantize_dense', 'quantize_unet', 'quantized_sites',
           'set_quantization']
