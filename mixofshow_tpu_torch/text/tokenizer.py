"""Pure-Python CLIP BPE tokenizer (host-side), standard library only.

Port of `mixofshow_tpu/text/tokenizer.py` with identical ids. The reference
pre-tokenizes with the third-party `regex` module's `\\p{L}`/`\\p{N}` classes;
this port classifies characters with `unicodedata` instead (`\\p{L}` is the
Unicode category L*, `\\p{N}` is N*, with the pattern's case-insensitive
edge, see `_kind`), so it needs no package beyond the standard library; the
tests compare the two on every code point.

Two modes:
  * real vocab: a directory with `vocab.json` + `merges.txt` (a diffusers
    checkpoint's `tokenizer/` subfolder) — byte-level BPE as in openai/CLIP.
  * fallback: no files — a deterministic hash vocabulary over the same id
    space (49408 tokens, bos=49406, eos=49407), for weight-less runs.

Added tokens (the `<newK>` concept tokens) are appended after the base vocab
in both modes, exactly like `tokenizer.add_tokens` in transformers.
"""
from __future__ import annotations

import functools
import gzip
import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

CLIP_VOCAB_SIZE = 49408
BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407

_SPECIALS = ('<|startoftext|>', '<|endoftext|>')
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte → unicode-char mapping."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', text).strip()


_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def basic_clean(text: str) -> str:
    """transformers CLIPTokenizer's input canonicalization without ftfy:
    strip control chars, space out CJK characters, NFC-normalize."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith('C') and ch not in '\t\n\r':
            continue
        if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            out.append(f' {ch} ')
        else:
            out.append(ch)
    return unicodedata.normalize('NFC', ''.join(out))


def _kind(ch: str) -> str:
    """'L' for \\p{L}, 'N' for \\p{N}, 'P' for the rest of the visible
    characters, ' ' for what no alternative matches: whitespace, and (the
    reference's pattern is case-insensitive) a non-letter whose case variant
    is a letter or number, such as U+0345, which folds to ι: the negated
    class excludes it, the positive class does not take it."""
    cat = unicodedata.category(ch)[0]
    if cat in 'LN':
        return cat
    if ch.isspace() or any(
            len(v) == 1 and unicodedata.category(v)[0] in 'LN'
            for v in (ch.casefold(), ch.upper(), ch.lower())):
        return ' '
    return 'P'


def pretokenize(text: str) -> List[str]:
    """CLIP's pre-tokenization, i.e. `findall` of the ordered alternation
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
    [^\\s\\p{L}\\p{N}]+` (case-insensitive) over already-lowercased text."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        hit = next((s for s in _SPECIALS + _CONTRACTIONS
                    if text[i:i + len(s)].lower() == s), None)
        if hit is not None:
            out.append(text[i:i + len(hit)])
            i += len(hit)
            continue
        kind = _kind(text[i])
        if kind == ' ':
            i += 1
            continue
        if kind == 'N':
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _kind(text[j]) == kind:
            j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """CLIP byte-level BPE with added-token support and max_length padding."""

    def __init__(self, vocab_dir: Optional[str] = None,
                 model_max_length: int = 77):
        self.model_max_length = model_max_length
        self.bos_token = '<|startoftext|>'
        self.eos_token = '<|endoftext|>'
        self.pad_token_id = EOS_TOKEN_ID  # SD1.x pads with eos
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.added_tokens: Dict[str, int] = {}
        self.cache = {self.bos_token: self.bos_token,
                      self.eos_token: self.eos_token}

        vocab_path = merges_path = None
        if vocab_dir is not None:
            for sub in ('', 'tokenizer'):
                d = os.path.join(vocab_dir, sub)
                if os.path.exists(os.path.join(d, 'vocab.json')):
                    vocab_path = os.path.join(d, 'vocab.json')
                    merges_path = os.path.join(d, 'merges.txt')
                    break
        if vocab_path is not None:
            with open(vocab_path, encoding='utf-8') as f:
                self.encoder: Dict[str, int] = json.load(f)
            opener = gzip.open if merges_path.endswith('.gz') else open
            with opener(merges_path, 'rt', encoding='utf-8') as f:
                merges = f.read().split('\n')
            # first line is a version header in openai/HF merges files
            merges = [tuple(m.split()) for m in merges[1:]
                      if m and len(m.split()) == 2]
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.decoder = {v: k for k, v in self.encoder.items()}
            self._fallback = False
        else:
            self.encoder = {self.bos_token: BOS_TOKEN_ID,
                            self.eos_token: EOS_TOKEN_ID}
            self.decoder = {v: k for k, v in self.encoder.items()}
            self.bpe_ranks = {}
            self._fallback = True

    # ------------------------------------------------------------- vocabulary
    def __len__(self) -> int:
        return CLIP_VOCAB_SIZE + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return CLIP_VOCAB_SIZE

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Append new tokens after the base vocab; returns # actually added."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for tok in tokens:
            if tok in self.added_tokens or tok in self.encoder:
                continue
            self.added_tokens[tok] = CLIP_VOCAB_SIZE + len(self.added_tokens)
            added += 1
        if added:
            # longest-first so '<new12>' is matched before '<new1>'
            pattern = '|'.join(
                re.escape(t) for t in
                sorted(self.added_tokens, key=len, reverse=True))
            self._added_re = re.compile(f'({pattern})')
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if self._fallback:
            return self._fallback_word_id(token)
        return self.encoder.get(token + '</w>',
                                self.encoder.get(token, EOS_TOKEN_ID))

    # -------------------------------------------------------------------- bpe
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = ' '.join(word)
        self.cache[token] = result
        return result

    def _fallback_word_id(self, word: str) -> int:
        """Deterministic id in [1000, 49000) for weight-less runs."""
        h = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4],
                           'little')
        return 1000 + h % 48000

    def _encode_text(self, text: str) -> List[int]:
        """BPE-encode one chunk of plain text (no added tokens inside)."""
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = []
        for token in pretokenize(text):
            if self._fallback:
                ids.append(self._fallback_word_id(token))
                continue
            btoken = ''.join(self.byte_encoder[b]
                             for b in token.encode('utf-8'))
            ids.extend(self.encoder[t] for t in self._bpe(btoken).split(' '))
        return ids

    # ----------------------------------------------------------------- encode
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        chunks = self._added_re.split(text) if self.added_tokens else [text]
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.added_tokens:
                ids.append(self.added_tokens[chunk])
            else:
                ids.extend(self._encode_text(chunk))
        if add_special_tokens:
            ids = [BOS_TOKEN_ID] + ids + [EOS_TOKEN_ID]
        return ids

    def __call__(self, texts: Union[str, Sequence[str]],
                 padding: str = 'max_length',
                 max_length: Optional[int] = None,
                 truncation: bool = True) -> np.ndarray:
        """Batch-encode to a fixed-shape (B, max_length) int32 array: pad
        with eos, truncate, always keep a final eos."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id,
                      dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [EOS_TOKEN_ID]
            out[row, :len(ids)] = np.asarray(ids, dtype=np.int32)
        return out
