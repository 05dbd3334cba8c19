"""CLIP text encoder (SD1.x text conditioning) as a torch module.

Port of mixofshow_tpu/models/clip.py: openai/clip-vit-large-patch14's text
tower (12 layers, width 768, 12 heads, quick-gelu, causal mask). ED-LoRA
specifics:
  * concept embeddings live in a separate (num_new_tokens, width) table
    passed at call time; token ids >= vocab_size index into it, so the base
    vocab table is never resized;
  * LoRA on the attention q/k/v/out projections threads through `lora`;
  * `capture_grams` also returns each block's fp32 input Grams for
    gradient fusion (ops/solve.py), rows masked by `token_mask`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mixofshow_tpu_torch.models.layers import dense, layer_norm, sdpa
from mixofshow_tpu_torch.models.lora import maybe
from mixofshow_tpu_torch.ops.solve import gram


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 77
    eps: float = 1e-5

    @staticmethod
    def sd15() -> 'CLIPTextConfig':
        return CLIPTextConfig()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _Attn(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.q = nn.Linear(c, c, **kw)
        self.k = nn.Linear(c, c, **kw)
        self.v = nn.Linear(c, c, **kw)
        self.out = nn.Linear(c, c, **kw)


class _MLP(nn.Module):
    def __init__(self, c, m, **kw):
        super().__init__()
        self.fc1 = nn.Linear(c, m, **kw)
        self.fc2 = nn.Linear(m, c, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.width, eps=cfg.eps, **kw)
        self.attn = _Attn(cfg.width, **kw)
        self.ln2 = nn.LayerNorm(cfg.width, eps=cfg.eps, **kw)
        self.mlp = _MLP(cfg.width, cfg.mlp_dim, **kw)


def embed_tokens(token_embedding: torch.Tensor, input_ids: torch.Tensor,
                 concept_embedding: Optional[torch.Tensor] = None):
    """Vocab lookup with a detached concept table for ids >= vocab_size:
    two clamped gathers and a select, no concatenated table."""
    vocab_size = token_embedding.shape[0]
    base = token_embedding[input_ids.clamp(0, vocab_size - 1)]
    if concept_embedding is None:
        return base
    n_new = concept_embedding.shape[0]
    new = concept_embedding[(input_ids - vocab_size).clamp(0, n_new - 1)]
    is_new = (input_ids >= vocab_size)[..., None]
    return torch.where(is_new, new.to(base.dtype), base)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, **kw)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.width,
                                               **kw)
        self.final_norm = nn.LayerNorm(cfg.width, eps=cfg.eps, **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.layers))

    def forward(self, input_ids: torch.Tensor,
                concept_embedding: Optional[torch.Tensor] = None,
                lora=None, lora_alpha: float = 1.0,
                capture_grams: bool = False,
                token_mask: Optional[torch.Tensor] = None):
        """last_hidden_state (B, S, width) after the final layer norm. With
        `capture_grams`, (last_hidden_state, [{'qkv', 'out', 'fc1', 'fc2'}
        per block]): the fp32 Gram of each linear's input over the rows
        where `token_mask` (B, S) is set (JAX `clip_text_encode`)."""
        x = embed_tokens(self.token_embedding.weight, input_ids,
                         concept_embedding)
        x = x + self.position_embedding.weight[:x.shape[1]].to(x.dtype)
        b, s, c = x.shape
        heads = self.cfg.heads
        grams = []
        for i, blk in enumerate(self.blocks):
            alora = maybe(lora, 'blocks', i, 'attn')
            attn_in = layer_norm(x, blk.ln1)
            q, k, v = (dense(attn_in, getattr(blk.attn, n), maybe(alora, n),
                             lora_alpha).view(b, s, heads, c // heads)
                       for n in ('q', 'k', 'v'))
            o = sdpa(q, k, v, causal=True).reshape(b, s, c)
            x = x + dense(o, blk.attn.out, maybe(alora, 'out'), lora_alpha)
            h = layer_norm(x, blk.ln2)
            mid = quick_gelu(dense(h, blk.mlp.fc1))
            x = x + dense(mid, blk.mlp.fc2)
            if capture_grams:
                grams.append({'qkv': gram(attn_in, token_mask),
                              'out': gram(o, token_mask),
                              'fc1': gram(h, token_mask),
                              'fc2': gram(mid, token_mask)})
        out = layer_norm(x, self.final_norm)
        return (out, grams) if capture_grams else out
