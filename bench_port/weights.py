"""Seeded weights, drawn on the device in a few large calls.

The benchmark, not the program, makes every weight: one uniform draw in
bfloat16 from a `torch.Generator` on the device, cut into views, one
`_foreach_mul_` by each tensor's bound, norms set to ones and zeros. The
program's modules and the plain reference's are filled from the same draw
of the same seed, in the same order (parameter names sorted), so they hold
the same numbers: the program in bfloat16, the reference the float32
products of the same bfloat16 draws.

Bounds: U[±1/√fan_in] for linear and convolution weights and biases (the
family's default init), ±0.02·√3 for embeddings (std 0.02), ±0.017·√3 for
concept rows (std 0.017, the `<rand-0.017>` init), LoRA down U[±1/√in]
and LoRA up U[±0.1/√rank] (a delta near a tenth of the weight it adds to,
where a freshly initialised LoRA would add nothing).
"""
from __future__ import annotations

import math

import torch
from torch import nn

LORA_UP_SCALE = 0.1
CONCEPT_STD = 0.017
EMBED_STD = 0.02


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one stream of draws of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def plan(module: nn.Module):
    """[(name, shape, bound or 'one' / 'zero')] of every parameter, sorted
    by name; bounds by the owning module's kind."""
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f'{mname}.{pname}' if mname else pname
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                kind = 'one' if pname == 'weight' else 'zero'
            elif isinstance(mod, nn.Embedding):
                kind = EMBED_STD * math.sqrt(3.0)
            else:
                kind = 1.0 / math.sqrt(mod.weight[0].numel())
            out.append((name, tuple(p.shape), kind))
    return sorted(out)


def draw(entries, gen: torch.Generator, device, dtype):
    """{name: tensor} for [(name, shape, bound or 'one' / 'zero')]: views of
    one bfloat16 uniform draw (cast to `dtype`) times their bounds."""
    drawn = [(n, s, b) for n, s, b in entries if not isinstance(b, str)]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    flat = flat.to(dtype)
    out, views, bounds, off = {}, [], [], 0
    for name, shape, bound in drawn:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        views.append(out[name])
        bounds.append(bound)
        off += n
    if views:
        torch._foreach_mul_(views, bounds)
    for name, shape, kind in entries:
        if isinstance(kind, str):
            fill = 1.0 if kind == 'one' else 0.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


def lora_entries(module: nn.Module, match, rank: int):
    """[(path, shape, bound)] of the LoRA down and up of every Linear whose
    '/'-joined module path passes `match`."""
    out = []
    for mname, mod in module.named_modules():
        path = mname.replace('.', '/')
        if isinstance(mod, nn.Linear) and match(path):
            fan_in, fan_out = mod.weight.shape[1], mod.weight.shape[0]
            out.append((f'{path}/down', (rank, fan_in),
                        1.0 / math.sqrt(fan_in)))
            out.append((f'{path}/up', (fan_out, rank),
                        LORA_UP_SCALE / math.sqrt(rank)))
    return sorted(out)


def lora_tree(tensors) -> dict:
    """{'a/b/down': t, 'a/b/up': t} -> {'a': {'b': {'down', 'up'}}}."""
    tree: dict = {}
    for path, t in tensors.items():
        node = tree
        parts = path.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree
