"""A diffusers-layout SD1.x checkpoint directory -> the port's modules.

Port of the checkpoint half of mixofshow_tpu/convert/diffusers_import.py
(reference ED-LoRA deltas are read by convert/delta_io.py). Keys map by
`diffusers_export.diffusers_key`, so loading is the inverse of saving and no
weight is transposed. Older VAE attention names (query/key/value/proj_attn,
1x1 convs) are taken too.

Widths come from each model's config.json where it has one, SD1.5's
otherwise (as the JAX loader assumes), and the text encoder's vocabulary
from its token table: a fused checkpoint carries 16 rows per concept token
after the base vocabulary (mixofshow_tpu/fusion/gradient_fusion.py
:510-514).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch
from torch import nn

from mixofshow_tpu_torch.convert import safetensors_io
from mixofshow_tpu_torch.convert.diffusers_export import (diffusers_key,
                                                          is_vae_linear)
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextConfig,
                                        CLIPTextModel, UNet, UNetConfig,
                                        VAEConfig)
from mixofshow_tpu_torch.utils.device import as_device

TOKEN_EMBEDDING = 'text_model.embeddings.token_embedding.weight'
_LEGACY_VAE = {'.query.': '.to_q.', '.key.': '.to_k.', '.value.': '.to_v.',
               '.proj_attn.': '.to_out.0.'}


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One weights file: .safetensors by hand, else a torch pickle (a
    'state_dict' entry is unwrapped)."""
    if path.endswith('.safetensors'):
        return safetensors_io.load_file(path)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return sd


def _find_weights(subdir: str) -> Optional[str]:
    if not os.path.isdir(subdir):
        return None
    for name in ('diffusion_pytorch_model.safetensors', 'model.safetensors',
                 'diffusion_pytorch_model.bin', 'pytorch_model.bin'):
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    return None


def _read_config(subdir: str) -> Dict:
    path = os.path.join(subdir, 'config.json')
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def unet_config(d: Dict) -> UNetConfig:
    base = UNetConfig.sd15()
    heads = d.get('attention_head_dim', base.attention_heads)
    return UNetConfig(
        in_channels=d.get('in_channels', base.in_channels),
        out_channels=d.get('out_channels', base.out_channels),
        block_out_channels=tuple(d.get('block_out_channels',
                                       base.block_out_channels)),
        layers_per_block=d.get('layers_per_block', base.layers_per_block),
        cross_attention_dim=d.get('cross_attention_dim',
                                  base.cross_attention_dim),
        attention_heads=heads if isinstance(heads, int) else heads[0],
        norm_groups=d.get('norm_num_groups', base.norm_groups),
        sample_size=d.get('sample_size', base.sample_size),
        down_cross=tuple(t.startswith('CrossAttn') for t in d[
            'down_block_types']) if 'down_block_types' in d
        else base.down_cross)


def vae_config(d: Dict) -> VAEConfig:
    base = VAEConfig.sd15()
    return VAEConfig(
        in_channels=d.get('in_channels', base.in_channels),
        latent_channels=d.get('latent_channels', base.latent_channels),
        block_out_channels=tuple(d.get('block_out_channels',
                                       base.block_out_channels)),
        layers_per_block=d.get('layers_per_block', base.layers_per_block),
        norm_groups=d.get('norm_num_groups', base.norm_groups),
        scaling_factor=d.get('scaling_factor', base.scaling_factor))


def text_config(d: Dict, vocab_size: int) -> CLIPTextConfig:
    base = CLIPTextConfig.sd15()
    return CLIPTextConfig(
        vocab_size=vocab_size, width=d.get('hidden_size', base.width),
        layers=d.get('num_hidden_layers', base.layers),
        heads=d.get('num_attention_heads', base.heads),
        mlp_dim=d.get('intermediate_size', base.mlp_dim),
        max_positions=d.get('max_position_embeddings', base.max_positions),
        eps=d.get('layer_norm_eps', base.eps))


def load_into(model: str, module: nn.Module,
              sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy a diffusers-keyed state dict into the port's `module` (cast to
    its dtype and device). Raises when a parameter is missing or its size
    differs; keys the module does not hold are ignored."""
    if model == 'vae':
        for old, new in _LEGACY_VAE.items():
            sd = {k.replace(old, new): v for k, v in sd.items()}
        sd = {k.replace('attentions.0.norm.', 'attentions.0.group_norm.'): v
              for k, v in sd.items()}
    own = module.state_dict()
    names = {k: diffusers_key(model, k) for k in own}
    missing = sorted(n for n in names.values() if n not in sd)
    if missing:
        raise KeyError(f'{model}: checkpoint lacks {len(missing)} weights, '
                       f'e.g. {missing[:5]}')
    new = {}
    for k, t in own.items():
        v = sd[names[k]]
        if v.numel() != t.numel() or (v.shape != t.shape and not (
                model == 'vae' and is_vae_linear(names[k]))):
            raise ValueError(f'{model}: {names[k]} is {tuple(v.shape)}, the '
                             f'port holds {tuple(t.shape)}')
        new[k] = v.reshape(t.shape)
    module.load_state_dict(new)
    return module


def load_pipeline_params(root: str, device, dtype=torch.float32) -> Dict:
    """A diffusers SD1.x directory -> {'unet', 'vae', 'text_encoder'}: each
    model the directory holds, on `device` in `dtype`."""
    dev = as_device(device)
    out: Dict = {}
    for model in ('unet', 'vae', 'text_encoder'):
        sub = os.path.join(root, model)
        path = _find_weights(sub)
        if path is None:
            continue
        sd = load_state_dict(path)
        d = _read_config(sub)
        if model == 'unet':
            module = UNet(unet_config(d), dev, dtype)
        elif model == 'vae':
            module = AutoencoderKL(vae_config(d), dev, dtype)
        else:
            module = CLIPTextModel(text_config(
                d, sd[TOKEN_EMBEDDING].shape[0]), dev, dtype)
        out[model] = load_into(model, module, sd).eval()
    return out
