"""LoRA deltas as a nested dict (port of mixofshow_tpu/models/lora.py).

A LoRA tree mirrors the module tree: wherever a model has a Linear or a 1x1
Conv2d, the tree may hold {'down': (r, in), 'up': (out, r)} at the same
path (dict keys for named children, int or str indices for lists). Model
forwards thread the matching subtree to each call site with `maybe`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn


def init_lora_leaf(rng: np.random.Generator, in_dim: int, out_dim: int,
                   rank: int = 4, device='cpu', dtype=torch.float32):
    """Kaiming-uniform down (bound 1/√in, the reference's a=√5 init), zero
    up. The down draw is the JAX package's (in, r) draw from the same numpy
    generator, transposed to (r, in)."""
    bound = 1.0 / math.sqrt(in_dim)
    down = rng.uniform(-bound, bound, (in_dim, rank)).astype(np.float32).T
    return {'down': torch.as_tensor(np.ascontiguousarray(down), dtype=dtype,
                                    device=device),
            'up': torch.zeros((out_dim, rank), dtype=dtype, device=device)}


def _is_linear_leaf(mod: nn.Module) -> bool:
    return isinstance(mod, nn.Linear) or (
        isinstance(mod, nn.Conv2d) and mod.kernel_size == (1, 1))


def _jax_order_modules(module: nn.Module, prefix: str = ''):
    """(path, module) depth first, children in the JAX parameter tree's key
    order: registration order, unless a module lists its children's JAX
    order in `JAX_CHILD_ORDER`."""
    children = list(module.named_children())
    order = getattr(module, 'JAX_CHILD_ORDER', None)
    if order:
        children.sort(key=lambda nc: order.index(nc[0]))
    for name, child in children:
        path = f'{prefix}/{name}' if prefix else name
        yield path, child
        yield from _jax_order_modules(child, path)


def init_lora_tree(rng: np.random.Generator, module: nn.Module,
                   path_filter: Callable[[str], bool], rank: int = 4,
                   device='cpu', dtype=torch.float32) -> Dict:
    """A LoRA leaf for every Linear or 1x1 Conv2d whose '/'-joined module
    path (e.g. 'down_blocks/0/attentions/0/attn1/to_q') passes
    `path_filter`. Leaves are drawn in the JAX parameter tree's order, so
    the same numpy generator state gives the same leaves as the JAX
    package's `init_lora_tree`."""
    tree: Dict = {}
    for path, mod in _jax_order_modules(module):
        if not _is_linear_leaf(mod) or not path_filter(path):
            continue
        set_path(tree, path, init_lora_leaf(
            rng, mod.weight.shape[1], mod.weight.shape[0], rank, device,
            dtype))
    return tree


def flatten_lora(tree, prefix: str = '') -> Dict[str, Dict]:
    """{'/'-joined path: {'down', 'up'}} for I/O."""
    out = {}

    def walk(node, path):
        if is_lora_leaf(node):
            out[path] = node
            return
        if isinstance(node, dict):
            for name, child in node.items():
                walk(child, f'{path}/{name}' if path else str(name))

    walk(tree, prefix)
    return out


def set_path(tree: Dict, path: str, value) -> None:
    """tree['a']['b']... = value for path 'a/b/...', making the dicts on
    the way."""
    parts = path.split('/')
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def get_module(module: nn.Module, path: str) -> nn.Module:
    """The submodule at a '/'-joined path ('down_blocks/0/attentions/1/
    attn2/to_k')."""
    for part in path.split('/'):
        module = module[int(part)] if isinstance(module, nn.ModuleList) \
            else getattr(module, part)
    return module


def num_lora_leaves(tree) -> int:
    return len(flatten_lora(tree))


def is_lora_leaf(node) -> bool:
    return isinstance(node, dict) and set(node) == {'down', 'up'}


def maybe(tree: Optional[dict], *names):
    """Walk `names` through an optional LoRA tree; None when absent."""
    node = tree
    for name in names:
        if node is None:
            return None
        if isinstance(node, (list, tuple)):
            name = int(name)
            node = node[name] if name < len(node) else None
        else:
            node = node.get(str(name)) if isinstance(name, int) \
                else node.get(name)
    return node


def map_lora(tree, fn):
    """Apply `fn` to every tensor of a LoRA tree; returns a new tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_lora(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_lora(v, fn) for v in tree]
    return fn(tree)


@torch.no_grad()
def merge_into(module: nn.Module, lora_tree, alpha: float = 1.0) -> nn.Module:
    """Fold every LoRA delta into the module's weights IN PLACE
    (W += alpha · up @ down) and return the module — the deployment path;
    in place because a merged copy of an SD1.5 UNet would double its
    memory."""
    def walk(mod, node):
        if node is None:
            return
        if is_lora_leaf(node):
            w = mod.weight
            delta = (node['up'].float() @ node['down'].float()).to(w.dtype)
            w.add_(alpha * delta.reshape(w.shape))
            return
        for name, child in node.items():
            walk(getattr(mod, name) if not isinstance(mod, nn.ModuleList)
                 else mod[int(name)], child)

    walk(module, lora_tree)
    return module
