"""Plain reference of the text side: CLIP's tokenization of ASCII prompts
in the weight-less hashed vocabulary, and Mix-of-Show's layer-wise concept
prompts. Imports nothing of the program under test.

Tokenization follows openai/CLIP on lower-cased, whitespace-collapsed
text: added tokens (the `<newN>` concept tokens) are cut out first, the
rest is split by CLIP's pattern (contractions, runs of letters, single
digits, runs of other visible characters), and each piece takes the id
1000 + (the first four bytes of its sha256, little-endian) mod 48000, the
hashed vocabulary a checkpoint without tokenizer files uses. Rows are
[bos] + ids + [eos], truncated to keep the final eos, padded with eos.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np

VOCAB = 49408
BOS, EOS = 49406, 49407
PIECE = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"
                   r"'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def piece_id(piece: str) -> int:
    h = int.from_bytes(hashlib.sha256(piece.encode()).digest()[:4], 'little')
    return 1000 + h % 48000


def encode(text: str, added: dict) -> list:
    if not text.isascii():
        raise ValueError(f'the reference tokenizes ASCII prompts: {text!r}')
    ids = []
    if added:
        pattern = '|'.join(re.escape(t) for t in
                           sorted(added, key=len, reverse=True))
        chunks = re.split(f'({pattern})', text)
    else:
        chunks = [text]
    for chunk in chunks:
        if chunk in added:
            ids.append(added[chunk])
        elif chunk:
            clean = re.sub(r'\s+', ' ', chunk).strip().lower()
            ids.extend(piece_id(p) for p in PIECE.findall(clean))
    return [BOS] + ids + [EOS]


def tokenize(texts, added: dict, length: int = 77) -> np.ndarray:
    out = np.full((len(texts), length), EOS, np.int64)
    for row, text in enumerate(texts):
        ids = encode(text, added)
        if len(ids) > length:
            ids = ids[:length - 1] + [EOS]
        out[row, :len(ids)] = ids
    return out


def layer_prompts(prompt: str, concepts: dict, layers: int = 16) -> list:
    """The prompt once per cross-attention layer, each concept name
    replaced by that layer's token."""
    out = [prompt] * layers
    for name, tokens in concepts.items():
        out = [p.replace(name, tok) for p, tok in zip(out, tokens)]
    return out
