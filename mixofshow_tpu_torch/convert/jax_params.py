"""Carry the JAX package's parameter trees into the port's modules.

The inverse direction of mixofshow_tpu/convert/diffusers_import.py, for the
trees `mixofshow_tpu` builds (nested dicts/lists of numpy arrays — pass
`jax.tree.map(np.asarray, tree)`). Imports no jax.

  * dense kernel (in, out)        -> Linear.weight = kernelᵀ (out, in)
  * conv kernel HWIO              -> Conv2d.weight OIHW
  * norm {scale, bias}            -> {weight, bias}
  * a bare table (token/position embedding) -> <name>.weight
  * LoRA {down: (in, r), up: (r, out)} -> {down: (r, in), up: (out, r)}
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _walk(tree, prefix: str = '') -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, np.asarray(tree)
        return
    for k, v in items:
        yield from _walk(v, f'{prefix}.{k}' if prefix else str(k))


def state_dict_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict with the port's names and layouts."""
    out = {}
    for path, arr in _walk(tree):
        head, _, leaf = path.rpartition('.')
        if leaf == 'kernel':
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            key = f'{head}.weight'
        elif leaf == 'scale':
            key = f'{head}.weight'
        elif leaf == 'bias':
            key = path
        else:
            key = f'{path}.weight'
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX tree into `module` (cast to its dtype and device): every
    parameter the module holds, the VAE's encoder and quant_conv included.
    Raises when the tree lacks any of them; entries the module does not hold
    are ignored."""
    sd = state_dict_from_jax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f'JAX tree lacks {len(missing)} parameters, e.g. '
                       f'{missing[:5]}')
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f'{k}: JAX {tuple(sd[k].shape)} vs port '
                             f'{tuple(v.shape)}')
    module.load_state_dict({k: sd[k] for k in own})
    return module


def lora_from_jax(tree, device, dtype=torch.float32):
    """JAX LoRA tree -> the port's nested dict with (r, in)/(out, r) leaves."""
    if isinstance(tree, dict) and set(tree) == {'down', 'up'}:
        return {name: torch.as_tensor(np.asarray(tree[name]).T.copy(),
                                      dtype=dtype, device=device)
                for name in ('down', 'up')}
    return {str(k): lora_from_jax(v, device, dtype) for k, v in tree.items()}
