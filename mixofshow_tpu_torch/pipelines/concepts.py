"""ED-LoRA concept tokens (port of mixofshow_tpu/pipelines/concepts.py).

Each concept gets 16 per-cross-attention-layer embeddings. Prompts naming the
concept are expanded into 16 layer-specific variants whose encodings feed the
UNet as a (B, 16, 77, C) layerwise tensor. Concept embeddings live in a
standalone `(num_tokens, C)` table beside the frozen vocab table (see
models/clip.embed_tokens).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from mixofshow_tpu_torch.text.tokenizer import CLIPTokenizer

NUM_CROSS_ATTENTION_LAYERS = 16


def bind_concept_prompt(prompts: Union[str, Sequence[str]],
                        new_concept_cfg: Dict) -> List[str]:
    """Expand each prompt into 16 per-layer variants, substituting each
    concept name with that layer's token names."""
    if isinstance(prompts, str):
        prompts = [prompts]
    out: List[str] = []
    for prompt in prompts:
        layer_prompts = [prompt] * NUM_CROSS_ATTENTION_LAYERS
        for concept_name, cfg in new_concept_cfg.items():
            layer_prompts = [
                p.replace(concept_name, layer_name)
                for p, layer_name in zip(layer_prompts,
                                         cfg['concept_token_names'])
            ]
        out.extend(layer_prompts)
    return out


def init_concepts(tokenizer: CLIPTokenizer,
                  new_concept_token: str,
                  initializer_token: Optional[str],
                  base_embedding,
                  rng: Optional[np.random.Generator] = None,
                  enable_edlora: bool = True) -> Tuple[Dict, np.ndarray]:
    """Register concept tokens and build the initial concept-embedding table.

    Concepts split on '+', each getting 16 tokens `<new{idx*16+layer}>`, one
    per cross-attention layer (1 when not `enable_edlora`); rows start from
    an existing token's embedding or from `<rand-σ>` gaussian noise drawn
    from `rng` (numpy, as in the reference, so both packages build the same
    table). `base_embedding` is the (vocab, C) token table (numpy or a
    tensor).

    Returns (new_concept_cfg, concept_embedding (total_new_tokens, C) fp32);
    `concept_embedding[token_id - vocab_size]` is the row for `token_id`.
    """
    rng = rng or np.random.default_rng(0)
    concepts = new_concept_token.split('+')
    if initializer_token is None:
        init_tokens = ['<rand-0.017>'] * len(concepts)
    else:
        init_tokens = initializer_token.split('+')
    if len(concepts) != len(init_tokens):
        raise ValueError('concept token should match init token.')

    dim = base_embedding.shape[1]
    new_concept_cfg: Dict = {}
    rows: List[np.ndarray] = []
    n_layers = NUM_CROSS_ATTENTION_LAYERS if enable_edlora else 1
    for idx, (concept_name, init_token) in enumerate(zip(concepts,
                                                         init_tokens)):
        names = [f'<new{idx * n_layers + layer}>' for layer in range(n_layers)]
        if tokenizer.add_tokens(names) != len(names):
            raise ValueError('some token is already in tokenizer')
        ids = [tokenizer.convert_tokens_to_ids(n) for n in names]

        m = re.findall(r'<rand-(.*)>', init_token)
        if m:
            init_feature = rng.normal(0.0, 1.0, (dim,)) * float(m[0])
        else:
            token_ids = tokenizer.encode(init_token, add_special_tokens=False)
            if len(token_ids) > 1:
                raise ValueError(
                    'The initializer token must be a single existing token.')
            row = base_embedding[token_ids[0]]
            if hasattr(row, 'detach'):
                row = row.detach().float().cpu().numpy()
            init_feature = np.asarray(row)
        rows.extend([init_feature.copy() for _ in ids])

        new_concept_cfg[concept_name] = {
            'concept_token_ids': ids,
            'concept_token_names': names,
        }

    table = np.stack(rows).astype(np.float32) if rows else \
        np.zeros((0, dim), np.float32)
    return new_concept_cfg, table


def all_concept_token_ids(new_concept_cfg: Dict) -> List[int]:
    """Flattened token ids of every concept, in concept order."""
    ids: List[int] = []
    for cfg in new_concept_cfg.values():
        ids.extend(cfg['concept_token_ids'])
    return ids
