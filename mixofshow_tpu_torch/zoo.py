"""Model bundles (port of mixofshow_tpu/zoo.py, random-init forms only).

`pretrained_path` forms in this slice:
  random:sd15 | random:tiny — random init at that size, on an explicit
  device, from a seeded torch.Generator on that device.
`load_t2i_adapter` makes random keypose or sketch adapters the same way.
Checkpoint directories arrive in a later slice.

Random weights from the same seed differ between this package and the JAX
package (torch.Generator vs numpy); parity tests carry the JAX weights
across with convert.load_jax_params instead.
"""
from __future__ import annotations

import dataclasses

import torch

from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextConfig,
                                        CLIPTextModel, UNet, UNetConfig,
                                        VAEConfig)
from mixofshow_tpu_torch.models.layers import seeded_init_
from mixofshow_tpu_torch.models.t2i_adapter import (T2IAdapter,
                                                    T2IAdapterConfig)
from mixofshow_tpu_torch.text import CLIPTokenizer
from mixofshow_tpu_torch.utils.device import as_device


@dataclasses.dataclass
class ModelBundle:
    unet: UNet
    text_encoder: CLIPTextModel
    vae: AutoencoderKL
    tokenizer: CLIPTokenizer


def tiny_configs():
    u = UNetConfig.tiny()
    c = CLIPTextConfig(width=u.cross_attention_dim, layers=2, heads=2,
                       mlp_dim=128)
    v = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_groups=8)
    return u, c, v


def load_models(pretrained_path: str, device, seed: int = 0,
                dtype=torch.float32) -> ModelBundle:
    """Random-init bundle: 'random:sd15' or 'random:tiny'. UNet, text encoder
    and VAE draw from generators seeded seed, seed+1, seed+2 on `device`
    (fp32 draws, cast to `dtype`)."""
    dev = as_device(device)
    size = pretrained_path.split(':')[-1] if pretrained_path else ''
    if not pretrained_path.startswith('random:') or size not in ('sd15',
                                                                 'tiny'):
        raise ValueError(f'unsupported pretrained_path {pretrained_path!r}: '
                         'this slice supports random:sd15 and random:tiny')
    ucfg, ccfg, vcfg = tiny_configs() if size == 'tiny' else (
        UNetConfig.sd15(), CLIPTextConfig.sd15(), VAEConfig.sd15())

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    with torch.no_grad():
        unet = seeded_init_(UNet(ucfg, dev, dtype), gen(0))
        te = seeded_init_(CLIPTextModel(ccfg, dev, dtype), gen(1))
        vae = seeded_init_(AutoencoderKL(vcfg, dev, dtype), gen(2))
    return ModelBundle(unet.eval(), te.eval(), vae.eval(), CLIPTokenizer())


def load_t2i_adapter(kind: str, size: str, device, seed: int = 0,
                     dtype=torch.float32) -> T2IAdapter:
    """Random-init T2I-Adapter: `kind` 'keypose' (3 input channels) or
    'sketch' (1), `size` 'sd15' (channels 320/640/1280/1280) or 'tiny', drawn
    from a generator seeded `seed` on `device`."""
    cins = {'keypose': 3, 'sketch': 1}
    if kind not in cins or size not in ('sd15', 'tiny'):
        raise ValueError(f'unsupported adapter {kind!r} at {size!r}')
    cfg = T2IAdapterConfig.tiny(cins[kind]) if size == 'tiny' else \
        T2IAdapterConfig(in_channels=cins[kind])
    dev = as_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return seeded_init_(T2IAdapter(cfg, dev, dtype), gen).eval()
