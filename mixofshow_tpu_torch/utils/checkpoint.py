"""Full train-state checkpoints, for resuming ED-LoRA tuning.

Port of mixofshow_tpu/utils/checkpoint.py. The reference cannot resume: it
saves the delta alone (SURVEY.md §5). Here the whole `TrainState`
round-trips: the trainable tensors (concept table and the two LoRA trees),
the AdamW state, the LambdaLR state, the micro-step count `step`,
`grad_accum` and the sticky `emb_frozen` flag.

The one deliberate difference from the JAX package is the file: the JAX
package writes an orbax directory, the port one `torch.save` file of
tensors and plain values (`train_state-<tag>.pt`), read back with
`weights_only=True`. A JAX orbax state does not load here.
"""
from __future__ import annotations

from typing import Dict

import torch

from mixofshow_tpu_torch.models.lora import flatten_lora, map_lora


def _cpu(obj):
    """CPU clones of every tensor in nested dicts, lists and tuples."""
    if torch.is_tensor(obj):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def train_state_dict(state) -> Dict:
    """The state as CPU tensors and plain values (what `save_train_state`
    writes)."""
    return {
        'trainable': map_lora(state.trainable,
                              lambda t: t.detach().to('cpu', copy=True)),
        'optimizer': _cpu(state.optimizer.state_dict()),
        'lr_schedule': _cpu(state.lr_schedule.state_dict()),
        'step': int(state.step),
        'grad_accum': int(state.grad_accum),
        'emb_frozen': state.emb_frozen.detach().to('cpu', copy=True),
    }


def save_train_state(path: str, state) -> str:
    """Write the state to `path` (one torch.save file); returns `path`."""
    torch.save(train_state_dict(state), path)
    return path


def _leaves(trainable: Dict) -> Dict[str, torch.Tensor]:
    out = {'concept_embedding': trainable['concept_embedding']}
    for key in ('text_lora', 'unet_lora'):
        for path, leaf in flatten_lora(trainable[key] or {}).items():
            for part in ('down', 'up'):
                out[f'{key}/{path}/{part}'] = leaf[part]
    return out


def load_train_state(path: str, state):
    """Load a `save_train_state` file into `state` IN PLACE (from
    `trainer.init_state` of the same configuration: the same leaves, shapes
    and accumulation count) and return it. The trainable tensors keep their
    identity, so the optimizer still holds them."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    if saved['grad_accum'] != state.grad_accum:
        raise ValueError(f'{path} was saved with grad_accum '
                         f'{saved["grad_accum"]}, this run has '
                         f'{state.grad_accum}')
    src, dst = _leaves(saved['trainable']), _leaves(state.trainable)
    if set(src) != set(dst):
        raise ValueError(f'{path} holds other trainable leaves: '
                         f'{sorted(set(src) ^ set(dst))[:4]}')
    with torch.no_grad():
        for name, t in dst.items():
            if src[name].shape != t.shape:
                raise ValueError(f'{path}: {name} has shape '
                                 f'{tuple(src[name].shape)}, expected '
                                 f'{tuple(t.shape)}')
            t.copy_(src[name])
    state.optimizer.load_state_dict(saved['optimizer'])
    state.lr_schedule.load_state_dict(saved['lr_schedule'])
    state.step = saved['step']
    state.emb_frozen = saved['emb_frozen'].to(state.emb_frozen.device)
    return state
