"""Region-masked cross-attention of regional sampling, and its plain twin.

Port of mixofshow_tpu/ops/region_attention.py: `region_attention` (K7,
csrc/region_attn.cu) replaces `_kernel`. Every pixel attends to the global
text context (77 keys); a pixel inside one or more region boxes instead
takes the overlap-counted mean of its attention against each of those
regions' contexts (reference pipeline_regionally_t2iadapter.py:32-86).

Boxes are pixel bounds (sh, sw, eh, ew), end exclusive, at the layer's grid,
rasterized on the host by `boxes_to_grid` and passed to the kernel by value:
no device copy and no host sync per launch.

The wrapper runs `region_attention_plain` for CPU tensors and launches the
kernel for CUDA tensors; `region_attention_supported` is the routing rule
the caller applies before either, and `region_blend` (the twin's policy,
over any attention function) takes the layouts the kernel refuses. `region_attention.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops.fused_attention import attn_fwd_plain

# what csrc/region_attn.cu takes: the region K/V tile and its output
# accumulator fit a warp's registers and a block's shared memory
MAX_REGIONS = 16
MAX_HEAD_DIM = 160
MAX_KEYS = 128


def boxes_to_grid(boxes, h: int, w: int) -> np.ndarray:
    """Normalized (R, 4) boxes -> int32 (R, 4) pixel bounds at (h, w): ceil
    on the start, floor on the end, computed in float32 as the JAX package
    does (in float64, 0.35 * 20 would ceil to 8 instead of 7)."""
    b = np.asarray(boxes, np.float32).reshape(-1, 4) \
        * np.asarray([h, w, h, w], np.float32)
    return np.concatenate([np.ceil(b[:, :2]), np.floor(b[:, 2:])],
                          axis=1).astype(np.int32)


def box_mask(box_px, h: int, w: int, device) -> torch.Tensor:
    """(h, w) fp32 mask of one pixel box (sh, sw, eh, ew)."""
    sh, sw, eh, ew = (int(v) for v in box_px)
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return ((rows >= sh) & (rows < eh) & (cols >= sw) & (cols < ew)).float()


def region_attention_supported(heads: int, d: int, sk: int, nr: int) -> bool:
    """Routing rule: the kernel takes 1..MAX_REGIONS regions, heads up to
    MAX_HEAD_DIM wide and up to MAX_KEYS keys (SD1.x: D 40-160, 77 keys)."""
    return 1 <= nr <= MAX_REGIONS and d <= MAX_HEAD_DIM and sk <= MAX_KEYS


def region_blend(attend, q, g_k, g_v, r_k, r_v, boxes_px,
                 hw: Tuple[int, int]):
    """The blend policy of regional attention, as the JAX package's XLA
    path computes it: `attend(q, k, v)` against the global context
    everywhere, replaced inside the boxes by the overlap-counted mean (in
    fp32) of `attend` against each region's context. Shapes as in
    `region_attention`; returned in the dtype `attend` gives."""
    h, w = hw
    out = attend(q, g_k, g_v)
    acc = torch.zeros(out.shape, dtype=torch.float32, device=out.device)
    cnt = torch.zeros(h * w, device=out.device)
    for i, box in enumerate(np.asarray(boxes_px).reshape(-1, 4)):
        m = box_mask(box, h, w, out.device).reshape(-1)
        acc += m[None, :, None, None] * attend(q, r_k[i], r_v[i]).float()
        cnt += m
    blended = acc / torch.clamp(cnt, min=1.0)[None, :, None, None]
    return torch.where((cnt > 0)[None, :, None, None],
                       blended.to(out.dtype), out)


def region_attention_plain(q, g_k, g_v, r_k, r_v, boxes_px,
                           hw: Tuple[int, int]):
    """The same function in plain PyTorch, fp32 throughout: `region_blend`
    of `attn_fwd_plain`. Returned in q's dtype."""
    return region_blend(attn_fwd_plain, *(t.float() for t in (q, g_k, g_v,
                                                              r_k, r_v)),
                        boxes_px, hw).to(q.dtype)


def region_attention(q, g_k, g_v, r_k, r_v, boxes_px, hw: Tuple[int, int]):
    """Regional cross-attention, K7.

    q (B, h·w, H, D); g_k/g_v (B, Sk, H, D) global context; r_k/r_v
    (R, B, Sk, H, D) per-region contexts; boxes_px (R, 4) int pixel bounds
    at hw = (h, w). Returns (B, h·w, H, D) in q's dtype. CUDA tensors
    (contiguous, all fp32 or all bf16) launch csrc/region_attn.cu; CPU
    tensors run `region_attention_plain`."""
    boxes = np.asarray(boxes_px, np.int32).reshape(-1, 4)
    _build.forward_only('region_attention', q, g_k, g_v, r_k, r_v)
    if _build.device_type(q, g_k, g_v, r_k, r_v) == 'cpu':
        return region_attention_plain(q, g_k, g_v, r_k, r_v, boxes, hw)
    b, n, heads, d = q.shape
    h, w = hw
    nr, sk = r_k.shape[0], g_k.shape[1]
    if h * w != n or g_k.shape != (b, sk, heads, d) or g_v.shape != \
            g_k.shape or r_k.shape != (nr, *g_k.shape) or r_v.shape != \
            r_k.shape or boxes.shape[0] != nr:
        raise ValueError(f'shape mismatch: q{tuple(q.shape)} hw{hw} '
                         f'g_k{tuple(g_k.shape)} g_v{tuple(g_v.shape)} '
                         f'r_k{tuple(r_k.shape)} r_v{tuple(r_v.shape)} '
                         f'boxes{boxes.shape}')
    if not region_attention_supported(heads, d, sk, nr):
        raise ValueError(f'region_attention takes 1..{MAX_REGIONS} regions, '
                         f'head dim <= {MAX_HEAD_DIM} and <= {MAX_KEYS} '
                         f'keys, got {nr}, {d}, {sk}')
    if not all(t.is_contiguous() for t in (q, g_k, g_v, r_k, r_v)):
        raise ValueError('region_attention needs contiguous tensors')
    code = _build.dtype_code(q, g_k, g_v, r_k, r_v)
    out = torch.empty_like(q)
    c_boxes = (ctypes.c_int * boxes.size)(*boxes.ravel().tolist())
    lib = _build.cuda_lib()
    with torch.cuda.device(q.device):
        rc = lib.mos_region_attn(
            q.data_ptr(), g_k.data_ptr(), g_v.data_ptr(), r_k.data_ptr(),
            r_v.data_ptr(), out.data_ptr(), b, n, heads, d, w, sk, nr,
            c_boxes, 1.0 / math.sqrt(d), code, _build.stream(q))
    _build.check(rc, 'region_attention')
    region_attention.launches += 1
    return out


region_attention.launches = 0

