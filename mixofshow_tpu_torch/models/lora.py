"""LoRA deltas as a nested dict (port of mixofshow_tpu/models/lora.py).

A LoRA tree mirrors the module tree: wherever a model has a Linear or a 1x1
Conv2d, the tree may hold {'down': (r, in), 'up': (out, r)} at the same
path (dict keys for named children, int or str indices for lists). Model
forwards thread the matching subtree to each call site with `maybe`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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
