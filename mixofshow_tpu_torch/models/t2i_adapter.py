"""T2I-Adapter condition network (keypose / sketch) as a torch module, NCHW.

Port of mixofshow_tpu/models/t2i_adapter.py: the diffusers `T2IAdapter`
'full_adapter' architecture, pixel-unshuffle(8) -> conv_in -> 4 stages
(AvgPool2d(2, ceil_mode=True) between stages, an optional 1x1 channel-change
`in_conv`, conv3x3-relu-conv1x1 resnets), one feature map per UNet down
block: [(c0, H/8), (c1, H/16), (c2, H/32), (c3, H/64)].

Module paths mirror the JAX parameter tree (`conv_in`,
`body.{i}.in_conv`, `body.{i}.resnets.{j}.block1/block2`), so
convert.load_jax_params carries it across, and they are the diffusers
checkpoint names without the `adapter.` prefix, so `convert_t2i_adapter`
loads a diffusers or an original TencentARC checkpoint without a transpose.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T2IAdapterConfig:
    in_channels: int = 3              # 3 keypose / 1 sketch
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_res_blocks: int = 2
    downscale_factor: int = 8

    @staticmethod
    def keypose() -> 'T2IAdapterConfig':
        return T2IAdapterConfig(in_channels=3)

    @staticmethod
    def sketch() -> 'T2IAdapterConfig':
        return T2IAdapterConfig(in_channels=1)

    @staticmethod
    def tiny(in_channels: int = 3) -> 'T2IAdapterConfig':
        return T2IAdapterConfig(in_channels=in_channels,
                                channels=(32, 64, 128, 128),
                                num_res_blocks=1)


class _Resnet(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.block1 = nn.Conv2d(c, c, 3, padding=1, **kw)
        self.block2 = nn.Conv2d(c, c, 1, **kw)

    def forward(self, x):
        return x + self.block2(F.relu(self.block1(x)))


class _Stage(nn.Module):
    def __init__(self, cin, cout, num_res_blocks, **kw):
        super().__init__()
        if cin != cout:
            self.in_conv = nn.Conv2d(cin, cout, 1, **kw)
        self.resnets = nn.ModuleList(_Resnet(cout, **kw)
                                     for _ in range(num_res_blocks))

    def forward(self, x):
        if hasattr(self, 'in_conv'):
            x = self.in_conv(x)
        for res in self.resnets:
            x = res(x)
        return x


class T2IAdapter(nn.Module):
    def __init__(self, cfg: T2IAdapterConfig, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        r2 = cfg.downscale_factor ** 2
        self.conv_in = nn.Conv2d(cfg.in_channels * r2, cfg.channels[0], 3,
                                 padding=1, **kw)
        cins = (cfg.channels[0],) + cfg.channels[:-1]
        self.body = nn.ModuleList(
            _Stage(cin, cout, cfg.num_res_blocks, **kw)
            for cin, cout in zip(cins, cfg.channels))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, C, H, W) condition image in [0, 1] -> 4 NCHW feature maps.
        Between stages, AvgPool2d(2, ceil_mode=True) divides a partial edge
        window (odd H or W) by its true element count, as diffusers does."""
        h = self.conv_in(F.pixel_unshuffle(x, self.cfg.downscale_factor))
        feats = []
        for i, stage in enumerate(self.body):
            if i > 0:
                h = F.avg_pool2d(h, 2, ceil_mode=True)
            h = stage(h)
            feats.append(h)
        return feats


def convert_t2i_adapter(sd: Dict, cfg: T2IAdapterConfig, device,
                        dtype=torch.float32) -> T2IAdapter:
    """A T2I-Adapter state dict -> the port's `T2IAdapter` on `device`.

    Takes both checkpoint layouts of the 'full_adapter' architecture, as the
    JAX package's convert_t2i_adapter does:
      * diffusers (`adapter.body.{i}.resnets.{j}.block1...`, with or without
        the `adapter.` prefix);
      * the original TencentARC `.pth` (flat `body.{k}.block1...` with k =
        stage * nums_rb + j and `in_conv` on the first block of a stage
        that changes channels; sk=True, use_conv=False, the
        t2iadapter_{keypose,sketch}_sd14v1 releases).
    The resnets a stage holds are counted from the checkpoint (`cfg`'s
    num_res_blocks is replaced by that count). A conv_in or body weight the
    module does not hold, or one it lacks, raises."""
    if (not any('.resnets.' in k for k in sd)
            and any(k.startswith('body.') and '.block1.' in k for k in sd)):
        sd = _original_to_diffusers_layout(sd, cfg)
    pre = 'adapter.' if any(k.startswith('adapter.') for k in sd) else ''
    own = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    nums = {len({k.split('.')[3] for k in own
                 if k.startswith(f'body.{i}.resnets.')})
            for i in range(len(cfg.channels))}
    if len(nums) != 1:
        raise ValueError(f'T2I-Adapter stages hold {sorted(nums)} resnets; '
                         'the full_adapter architecture has one count')
    cfg = dataclasses.replace(cfg, num_res_blocks=nums.pop())
    adapter = T2IAdapter(cfg, device, dtype)
    want = adapter.state_dict()
    held = {k for k in own if k.startswith(('conv_in.', 'body.'))}
    if held != set(want):
        raise KeyError(f'T2I-Adapter checkpoint: missing '
                       f'{sorted(set(want) - held)[:5]}, unexpected '
                       f'{sorted(held - set(want))[:5]}')
    for k, t in want.items():
        if tuple(own[k].shape) != tuple(t.shape):
            raise ValueError(f'T2I-Adapter {k} is {tuple(own[k].shape)}, '
                             f'the config gives {tuple(t.shape)}')
    adapter.load_state_dict({k: torch.as_tensor(own[k]) for k in want})
    return adapter.eval()


def _original_to_diffusers_layout(sd: Dict, cfg: T2IAdapterConfig) -> Dict:
    """Rename the original TencentARC flat keys to the diffusers layout.
    Rejects sk=False checkpoints (`skep` convs, a residual path the
    full_adapter architecture lacks) and use_conv=True ones (`down_opt`
    convs, a learned downsample where full_adapter avg-pools)."""
    if any('.skep.' in k for k in sd):
        raise ValueError(
            'original T2I-Adapter checkpoint with sk=False (skep convs) is '
            'not the full_adapter architecture the reference uses')
    if any('.down_opt.' in k for k in sd):
        raise ValueError(
            'original T2I-Adapter checkpoint with use_conv=True (down_opt '
            'convs) is not the avgpool full_adapter architecture')
    flat = sorted({int(k.split('.')[1]) for k in sd
                   if k.startswith('body.')})
    nums_rb = (len(flat) // len(cfg.channels)) or 1
    out = {}
    for k, v in sd.items():
        if not k.startswith('body.'):
            out[k] = v
            continue
        parts = k.split('.')
        idx = int(parts[1])
        i, j = idx // nums_rb, idx % nums_rb
        rest = '.'.join(parts[2:])
        if rest.startswith('in_conv.'):
            out[f'body.{i}.{rest}'] = v
        else:
            out[f'body.{i}.resnets.{j}.{rest}'] = v
    return out


def preprocess_adapter_image(image, height: int, width: int) -> np.ndarray:
    """PIL image, array or a list of them -> (B, H, W, C) float32 in [0, 1]
    (NHWC, as the JAX package returns it); PIL images are resized to
    (width, height)."""
    from PIL import Image
    if not isinstance(image, (list, tuple)):
        image = [image]
    out = []
    for img in image:
        if isinstance(img, Image.Image):
            img = img.resize((width, height))
            arr = np.asarray(img, np.float32) / 255.0
        else:
            arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        out.append(arr)
    return np.stack(out)
