"""The port's modules -> a diffusers-layout checkpoint directory.

Port of mixofshow_tpu/convert/diffusers_export.py, the surface the fused
checkpoint leaves through (the reference saves it with save_pretrained,
gradient_fusion.py:810-813). The port's state dicts are already in torch
layout (Linear (out, in), Conv2d OIHW), so export is a key map, not a
transpose: `diffusers_key` renames each key of a module's state_dict to the
name diffusers gives it. The one reshape: the VAE's mid-block attention
holds 1x1 convs where diffusers holds Linear weights (out, in).

`save_pipeline_params` writes unet/diffusion_pytorch_model.safetensors,
vae/diffusion_pytorch_model.safetensors, text_encoder/model.safetensors
(convert/safetensors_io.py), a config.json per model with the diffusers
names of its widths, and new_concept_cfg.json.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch
from torch import nn

from mixofshow_tpu_torch.convert.safetensors_io import save_file

_TFM = r'(?P<t>(?:^|\.)attentions\.\d+)\.'

# (pattern, replacement) in order, per model; each key's rename is the
# composition of all of them
_RULES = {
    'unet': [
        (r'^mid\.resnet([12])\.',
         lambda m: f'mid_block.resnets.{int(m[1]) - 1}.'),
        (r'^mid\.attention\.', 'mid_block.attentions.0.'),
        (r'^norm_out\.', 'conv_norm_out.'),
        (r'\.shortcut\.', '.conv_shortcut.'),
        (r'\.downsample\.', '.downsamplers.0.conv.'),
        (r'\.upsample\.', '.upsamplers.0.conv.'),
        (_TFM + r'ln([123])\.',
         r'\g<t>.transformer_blocks.0.norm\2.'),
        (_TFM + r'(attn[12])\.to_out\.',
         r'\g<t>.transformer_blocks.0.\2.to_out.0.'),
        (_TFM + r'(attn[12])\.to_([qkv])\.',
         r'\g<t>.transformer_blocks.0.\2.to_\3.'),
        (_TFM + r'ff\.proj\.', r'\g<t>.transformer_blocks.0.ff.net.0.proj.'),
        (_TFM + r'ff\.out\.', r'\g<t>.transformer_blocks.0.ff.net.2.'),
    ],
    'vae': [
        (r'^encoder\.down\.', 'encoder.down_blocks.'),
        (r'^decoder\.up\.', 'decoder.up_blocks.'),
        (r'\.mid\.resnet([12])\.',
         lambda m: f'.mid_block.resnets.{int(m[1]) - 1}.'),
        (r'\.mid\.attn\.norm\.', '.mid_block.attentions.0.group_norm.'),
        (r'\.mid\.attn\.([qkv])\.', r'.mid_block.attentions.0.to_\1.'),
        (r'\.mid\.attn\.proj\.', '.mid_block.attentions.0.to_out.0.'),
        (r'\.norm_out\.', '.conv_norm_out.'),
        (r'\.shortcut\.', '.conv_shortcut.'),
        (r'\.downsample\.', '.downsamplers.0.conv.'),
        (r'\.upsample\.', '.upsamplers.0.conv.'),
    ],
    'text_encoder': [
        (r'^(token|position)_embedding\.',
         r'text_model.embeddings.\1_embedding.'),
        (r'^final_norm\.', 'text_model.final_layer_norm.'),
        (r'^blocks\.(\d+)\.ln([12])\.',
         r'text_model.encoder.layers.\1.layer_norm\2.'),
        (r'^blocks\.(\d+)\.attn\.(q|k|v|out)\.',
         r'text_model.encoder.layers.\1.self_attn.\2_proj.'),
        (r'^blocks\.(\d+)\.mlp\.', r'text_model.encoder.layers.\1.mlp.'),
    ],
}

WEIGHT_FILES = {'unet': 'diffusion_pytorch_model.safetensors',
                'vae': 'diffusion_pytorch_model.safetensors',
                'text_encoder': 'model.safetensors'}


def diffusers_key(model: str, key: str) -> str:
    """A key of the port's `model` ('unet', 'vae', 'text_encoder')
    state_dict -> its diffusers / transformers name."""
    for pattern, repl in _RULES[model]:
        key = re.sub(pattern, repl, key)
    return key


def is_vae_linear(diffusers_name: str) -> bool:
    """The VAE mid-block attention's q/k/v/out weights: Linear in
    diffusers, 1x1 convs in the port."""
    return bool(re.search(r'mid_block\.attentions\.0\.to_(q|k|v|out\.0)'
                          r'\.weight$', diffusers_name))


def export_state_dict(model: str, sd: Dict[str, torch.Tensor]):
    """The port's state dict -> {diffusers key: tensor}."""
    out = {}
    for key, value in sd.items():
        name = diffusers_key(model, key)
        if model == 'vae' and is_vae_linear(name):
            value = value.reshape(value.shape[0], -1)
        out[name] = value
    return out


def diffusers_config(model: str, cfg) -> Dict:
    """The diffusers config.json entries that fix a model's widths."""
    if model == 'unet':
        return {
            'in_channels': cfg.in_channels, 'out_channels': cfg.out_channels,
            'block_out_channels': list(cfg.block_out_channels),
            'layers_per_block': cfg.layers_per_block,
            'cross_attention_dim': cfg.cross_attention_dim,
            'attention_head_dim': cfg.attention_heads,
            'norm_num_groups': cfg.norm_groups,
            'sample_size': cfg.sample_size,
            'down_block_types': ['CrossAttnDownBlock2D' if c else
                                 'DownBlock2D' for c in cfg.down_cross]}
    if model == 'vae':
        return {'in_channels': cfg.in_channels,
                'latent_channels': cfg.latent_channels,
                'block_out_channels': list(cfg.block_out_channels),
                'layers_per_block': cfg.layers_per_block,
                'norm_num_groups': cfg.norm_groups,
                'scaling_factor': cfg.scaling_factor}
    return {'vocab_size': cfg.vocab_size, 'hidden_size': cfg.width,
            'num_hidden_layers': cfg.layers,
            'num_attention_heads': cfg.heads,
            'intermediate_size': cfg.mlp_dim,
            'max_position_embeddings': cfg.max_positions,
            'layer_norm_eps': cfg.eps}


def save_pipeline_params(root: str, unet: Optional[nn.Module] = None,
                         vae: Optional[nn.Module] = None,
                         text_encoder: Optional[nn.Module] = None,
                         new_concept_cfg: Optional[Dict] = None) -> None:
    """Write a diffusers-layout directory: each given module's weights in
    its own dtype, its config.json, and the new_concept_cfg.json sidecar
    the regional sampler reloads (regionally_controlable_sampling.py
    :57-60)."""
    os.makedirs(root, exist_ok=True)
    for model, module in (('unet', unet), ('vae', vae),
                          ('text_encoder', text_encoder)):
        if module is None:
            continue
        d = os.path.join(root, model)
        os.makedirs(d, exist_ok=True)
        save_file(export_state_dict(model, module.state_dict()),
                  os.path.join(d, WEIGHT_FILES[model]))
        with open(os.path.join(d, 'config.json'), 'w') as f:
            json.dump(diffusers_config(model, module.cfg), f, indent=2)
    if new_concept_cfg is not None:
        with open(os.path.join(root, 'new_concept_cfg.json'), 'w') as f:
            json.dump(new_concept_cfg, f, indent=2)
