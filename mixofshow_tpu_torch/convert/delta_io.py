"""ED-LoRA delta checkpoints in the reference's on-disk format.

Port of the writing half of mixofshow_tpu/convert/delta_io.py. The reference
saves {'params': {new_concept_embedding, text_encoder, unet}} with
torch.save (train_edlora.py:165-171, structure trainer_edlora.py:362-379), so
deltas trained here load in the reference, in its convert_edlora, and in the
JAX package's `convert_edlora_delta`. The port's LoRA leaves already have
the reference's (r, in)/(out, r) layout.
"""
from __future__ import annotations

from typing import Dict

import torch

from mixofshow_tpu_torch.models.lora import flatten_lora


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
