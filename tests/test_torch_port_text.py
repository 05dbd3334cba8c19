"""Port parity: tokenizer ids and concept binding identical to the JAX
package (mixofshow_tpu.text / pipelines.concepts)."""
import json
import random
import string

import numpy as np
import pytest

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.pipelines import concepts as jconcepts
from mixofshow_tpu.text import tokenizer as jtok
from mixofshow_tpu_torch.pipelines import concepts as pconcepts
from mixofshow_tpu_torch.text import tokenizer as ptok

TEXTS = [
    'a photo of a dog', "it's 3 dogs, blue-ish!",
    "we'll I'M you're THEY'VE he'd can't", 'héllo wörld — café naïve',
    'emoji 🐶 and 🔥 fire', '24 cats & 7 dogs!!', 'x<|endoftext|>y',
    '   lots   of \t whitespace \n here ', 'unicode: 日本語 テスト',
    'don’t stop', 'a-b_c.d/e\\f @#$%', "''s !'s <|startoftext|>go",
    'Ⅻ ½ ² ٣ ૫ 𝟘 numbers', 'ǅemal Ǉ titlecase', 'İstanbul ß ﬁ', '',
    'aͅb !ͅ! ̈́͆ͅ 1ͅ',   # U+0345 folds to a letter: the pattern skips it
    ' '.join(['word'] * 200),
]


def _corpus(n=120, seed=3):
    rng = random.Random(seed)
    charset = (string.ascii_letters + "0123456789'!,.-—é日🐱<>|_ \t"
               + 'Ⅻⅷ½²٣૫Ωабв  　​\x85')
    return TEXTS + [''.join(rng.choice(charset)
                            for _ in range(rng.randint(1, 40)))
                    for _ in range(n)]


def _bytelevel_vocab(tmp_path, seed=11, n_merges=300):
    """A CLIP-shaped vocab/merges pair: the 256 byte symbols (+ '</w>'),
    random letter merges, filler up to 49408 ids, bos/eos at 49406/49407."""
    b2u = jtok.bytes_to_unicode()
    syms = list(b2u.values())
    vocab_tokens = syms + [s + '</w>' for s in syms]
    rng = random.Random(seed)
    letters = [b2u[ord(c)] for c in 'abcdefghijklmnopqrstuvwxyz']
    pool = letters + [s + '</w>' for s in letters]
    merges, seen = [], set()
    while len(merges) < n_merges:
        a, b = rng.choice([s for s in pool if not s.endswith('</w>')]), \
            rng.choice(pool)
        if (a, b) in seen or len(a + b) > 14:
            continue
        seen.add((a, b))
        merges.append((a, b))
        pool.append(a + b)
        if a + b not in vocab_tokens:
            vocab_tokens.append(a + b)
    vocab_tokens += [f'[fill{i}]' for i in
                     range(jtok.CLIP_VOCAB_SIZE - 2 - len(vocab_tokens))]
    vocab_tokens += ['<|startoftext|>', '<|endoftext|>']
    (tmp_path / 'vocab.json').write_text(
        json.dumps({t: i for i, t in enumerate(vocab_tokens)},
                   ensure_ascii=False), encoding='utf-8')
    (tmp_path / 'merges.txt').write_text(
        '\n'.join(['#version: 0.2'] + [f'{a} {b}' for a, b in merges]),
        encoding='utf-8')
    return str(tmp_path)


def test_pretokenize_matches_jax_regex():
    """The stdlib pre-tokenizer equals the reference's `regex` pattern."""
    for text in _corpus(400, seed=5):
        clean = jtok.whitespace_clean(jtok.basic_clean(text)).lower()
        assert ptok.whitespace_clean(ptok.basic_clean(text)).lower() == clean
        assert ptok.pretokenize(clean) == jtok._PAT.findall(clean), text


def test_pretokenize_matches_jax_on_every_code_point():
    """Every Unicode scalar value, in runs of 512 and spaced out."""
    chars = ''.join(chr(c) for c in range(0x110000)
                    if not 0xD800 <= c <= 0xDFFF)
    for i in range(0, len(chars), 512):
        chunk = chars[i:i + 512]
        text = chunk + ' '.join(chunk)
        clean = jtok.whitespace_clean(jtok.basic_clean(text)).lower()
        assert ptok.whitespace_clean(ptok.basic_clean(text)).lower() == clean
        assert ptok.pretokenize(clean) == jtok._PAT.findall(clean), hex(i)


@pytest.mark.parametrize('vocab', ['fallback', 'bytelevel'])
def test_tokenizer_ids_identical(vocab, tmp_path):
    vdir = None if vocab == 'fallback' else _bytelevel_vocab(tmp_path)
    jt, pt = jtok.CLIPTokenizer(vdir), ptok.CLIPTokenizer(vdir)
    texts = _corpus()
    for t in texts:
        assert pt.encode(t, add_special_tokens=False) == \
            jt.encode(t, add_special_tokens=False), t
    np.testing.assert_array_equal(pt(texts), jt(texts))
    np.testing.assert_array_equal(pt(texts[:4], max_length=10),
                                  jt(texts[:4], max_length=10))
    names = ['<new0>', '<new1>', '<new12>', '<g1>']
    assert pt.add_tokens(names) == jt.add_tokens(names) == 4
    assert pt.add_tokens(['<new0>']) == jt.add_tokens(['<new0>']) == 0
    with_concepts = ['a <new12> and <new0> here', '<new1>x<new12>',
                     'photo of <g1> on a beach']
    np.testing.assert_array_equal(pt(with_concepts + texts),
                                  jt(with_concepts + texts))
    for name in names:
        assert pt.convert_tokens_to_ids(name) == jt.convert_tokens_to_ids(name)


def test_bind_and_init_concepts_identical():
    base = np.random.default_rng(0).normal(size=(jtok.CLIP_VOCAB_SIZE, 16)) \
        .astype(np.float32)
    jt, pt = jtok.CLIPTokenizer(), ptok.CLIPTokenizer()
    jcfg, jtab = jconcepts.init_concepts(jt, '<g1>+<g2>', '<rand-0.013>+a',
                                         base)
    pcfg, ptab = pconcepts.init_concepts(pt, '<g1>+<g2>', '<rand-0.013>+a',
                                         base)
    assert pcfg == jcfg
    np.testing.assert_array_equal(ptab, jtab)
    prompts = ['a photo of <g1> and <g2>', 'a castle', '<g2><g1>']
    bound = pconcepts.bind_concept_prompt(prompts, pcfg)
    assert bound == jconcepts.bind_concept_prompt(prompts, jcfg)
    assert len(bound) == 3 * pconcepts.NUM_CROSS_ATTENTION_LAYERS
    np.testing.assert_array_equal(pt(bound), jt(bound))
    # one layer-specific token per concept per layer
    assert '<new5>' in bound[5] and '<new21>' in bound[5]


def test_init_concepts_rejects_multi_token_initializer(tmp_path):
    pt = ptok.CLIPTokenizer(_bytelevel_vocab(tmp_path))
    base = np.zeros((jtok.CLIP_VOCAB_SIZE, 4), np.float32)
    with pytest.raises(ValueError):
        pconcepts.init_concepts(pt, '<g1>', 'two words', base)
    with pytest.raises(ValueError):
        pconcepts.init_concepts(pt, '<g1>+<g2>', '<rand-0.1>', base)
