"""ED-LoRA delta checkpoints in the reference's on-disk format.

Port of mixofshow_tpu/convert/delta_io.py and of the delta half of
mixofshow_tpu/convert/diffusers_import.py (`convert_edlora_delta`). The
reference saves {'params': {new_concept_embedding, text_encoder, unet}} with
torch.save (train_edlora.py:165-171, structure trainer_edlora.py:362-379), so
deltas trained here load in the reference, in its convert_edlora, and in the
JAX package's `convert_edlora_delta`, and theirs load here. The port's LoRA
leaves already have the reference's (r, in)/(out, r) layout: nothing is
transposed in either direction.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mixofshow_tpu_torch.models.lora import flatten_lora, set_path


def _ours_to_torch_module(path: str) -> str:
    """A LoRA path of the port ('blocks/0/attn/q',
    'down_blocks/0/attentions/1/attn2/to_out', ...) -> the reference's
    module name."""
    parts = path.split('/')
    if parts[0] == 'blocks':
        proj = {'q': 'q_proj', 'k': 'k_proj', 'v': 'v_proj',
                'out': 'out_proj'}[parts[3]]
        return f'text_model.encoder.layers.{parts[1]}.self_attn.{proj}'
    if parts[0] == 'mid':
        base, inner = 'mid_block.attentions.0', parts[2:]
    else:
        # ['down_blocks' | 'up_blocks', i, 'attentions', j, ...]
        base, inner = f'{parts[0]}.{parts[1]}.attentions.{parts[3]}', parts[4:]
    if inner[0] in ('proj_in', 'proj_out'):  # convs on Transformer2DModel
        return f'{base}.{inner[0]}'
    if inner[0] == 'ff':  # diffusers FeedForward: net.0 = GEGLU, net.2 = out
        leaf = 'ff.net.0.proj' if inner[1] == 'proj' else 'ff.net.2'
    else:
        leaf = f"{inner[0]}.{'to_out.0' if inner[1] == 'to_out' else inner[1]}"
    return f'{base}.transformer_blocks.0.{leaf}'


def export_edlora_delta(delta: Dict) -> Dict:
    """`EDLoRATrainer.delta_state_dict` output -> the reference state dict:
    {'new_concept_embedding': {name: (L, C)}, 'text_encoder': {module
    .lora_down.weight / .lora_up.weight: tensor}, 'unet': {...}}, fp32 CPU
    tensors."""
    def cpu(t):
        return torch.as_tensor(t).detach().to('cpu', torch.float32).clone()

    out = {'new_concept_embedding': {name: cpu(emb) for name, emb in
                                     delta['new_concept_embedding'].items()},
           'text_encoder': {}, 'unet': {}}
    for tree_key, dst in (('text_lora', 'text_encoder'),
                          ('unet_lora', 'unet')):
        for path, leaf in flatten_lora(delta.get(tree_key) or {}).items():
            mod = _ours_to_torch_module(path)
            out[dst][f'{mod}.lora_down.weight'] = cpu(leaf['down'])
            out[dst][f'{mod}.lora_up.weight'] = cpu(leaf['up'])
    return out


def save_edlora_delta(path: str, delta: Dict) -> None:
    """torch.save({'params': export_edlora_delta(delta)}, path)."""
    torch.save({'params': export_edlora_delta(delta)}, path)


def load_edlora_delta(path: str) -> Dict:
    """A reference-format .pth -> {'params': {group: {key: tensor}}}, the
    input of `convert_edlora_delta`."""
    return torch.load(path, map_location='cpu', weights_only=True)


def _torch_module_to_ours(name: str) -> Optional[List[str]]:
    """Inverse of `_ours_to_torch_module`: a reference module name -> the
    port's LoRA path parts, None for a module the port has no LoRA site
    for.

    'down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k'
        -> ['down_blocks', '0', 'attentions', '1', 'attn2', 'to_k']
    'mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj'
        -> ['mid', 'attention', 'ff', 'proj']
    'up_blocks.1.attentions.2.proj_out'
        -> ['up_blocks', '1', 'attentions', '2', 'proj_out']
    'text_model.encoder.layers.3.self_attn.q_proj' -> ['blocks', '3',
        'attn', 'q']"""
    parts = name.split('.')
    if parts[0] == 'text_model':
        return ['blocks', parts[3], 'attn', parts[5][:-len('_proj')]]
    if parts[0] == 'mid_block':
        base, rest = ['mid', 'attention'], parts[3:]
    elif parts[0] in ('down_blocks', 'up_blocks'):
        base, rest = [parts[0], parts[1], 'attentions', parts[3]], parts[4:]
    else:
        return None
    if rest[:1] in (['proj_in'], ['proj_out']):
        return base + [rest[0]]
    if rest[:2] != ['transformer_blocks', '0']:
        return None
    inner = rest[2:]
    if inner[:2] == ['ff', 'net']:  # net.0.proj = GEGLU in, net.2 = out
        return base + ['ff', 'out' if inner[2] == '2' else 'proj']
    return base + [p for p in inner if p != '0']  # 'to_out.0' -> 'to_out'


def convert_edlora_delta(delta: Dict, device='cpu',
                         dtype=torch.float32) -> Dict:
    """A reference ED-LoRA state dict (raw or wrapped in {'params': ...})
    -> {'new_concept_embedding': {name: (16, C)}, 'text_lora': tree,
    'unet_lora': tree}, tensors on `device`. A 1x1-conv LoRA's (o, i, 1, 1)
    weights become (o, i); pairs missing a half, and modules without a LoRA
    site in the port, are dropped, as the JAX package drops them."""
    if isinstance(delta.get('params'), dict):
        delta = delta['params']

    def t(v):
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=dtype)

    out: Dict = {'new_concept_embedding': {
        name: t(emb) for name, emb in
        delta.get('new_concept_embedding', {}).items()},
        'text_lora': {}, 'unet_lora': {}}
    for src, dst in (('text_encoder', 'text_lora'), ('unet', 'unet_lora')):
        pairs: Dict[str, Dict] = {}
        for k, v in delta.get(src, {}).items():
            for which in ('down', 'up'):
                suffix = f'.lora_{which}.weight'
                if k.endswith(suffix):
                    w = t(v)
                    if w.dim() == 4:
                        w = w[:, :, 0, 0]
                    pairs.setdefault(k[:-len(suffix)], {})[which] = \
                        w.contiguous()
        for mod, leaf in pairs.items():
            path = _torch_module_to_ours(mod)
            if path is not None and set(leaf) == {'down', 'up'}:
                set_path(out[dst], '/'.join(path), leaf)
    return out
