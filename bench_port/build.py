"""The system under test and the plain reference, built from one
configuration file and filled from one seed.

`program(cfg, seed, device)` returns the port's modules (bfloat16, the
type they are served in), its tokenizer with the concept tokens added, and
the concept table and LoRA trees; `reference(cfg, seed, device)` the
reference's (float32) from the same draws. Each model draws from a stream
of its own (weights.generator), so a configuration without an adapter
leaves the others' numbers alone.
"""
from __future__ import annotations

import dataclasses

import torch

from bench_port import weights
from bench_port.reference import sd15

STREAMS = {'unet': 0, 'text_encoder': 1, 'vae': 2, 'adapter': 3,
           'extras': 4}
NUM_LAYERS = sd15.NUM_LAYERS


def reference_modules(cfg):
    """The reference's modules of `cfg` on the meta device."""
    u, c, v = cfg['unet'], cfg['text_encoder'], cfg['vae']
    with torch.device('meta'):
        mods = {
            'unet': sd15.UNet(tuple(u['block_out_channels']),
                              u['cross_attention_dim'],
                              u['attention_heads'], u['norm_groups'],
                              u['layers_per_block'], tuple(u['down_cross'])),
            'text_encoder': sd15.CLIPText(c['vocab_size'], c['width'],
                                          c['layers'], c['heads'],
                                          c['mlp_dim'], c['max_positions']),
            'vae': sd15.VAE(tuple(v['block_out_channels']),
                            v['norm_groups'], v['layers_per_block'])}
        if 'adapter' in cfg:
            a = cfg['adapter']
            mods['adapter'] = sd15.Adapter(a['in_channels'],
                                           tuple(a['channels']),
                                           a['num_res_blocks'])
    return mods


def concept_tokens(cfg):
    """{concept name: [its layer tokens]} and {token: id}: concept k's
    tokens are <new{16k + layer}>, after the base vocabulary."""
    vocab = cfg['text_encoder']['vocab_size']
    names, ids = {}, {}
    for k, name in enumerate(cfg['concepts']):
        names[name] = [f'<new{NUM_LAYERS * k + i}>'
                       for i in range(NUM_LAYERS)]
        for i, tok in enumerate(names[name]):
            ids[tok] = vocab + NUM_LAYERS * k + i
    return names, ids


def _extras_entries(cfg, mods):
    width = cfg['text_encoder']['width']
    out = [('concepts', (NUM_LAYERS * len(cfg['concepts']), width),
            weights.CONCEPT_STD * 3 ** 0.5)]
    lora = cfg.get('lora')
    if lora:
        out += [(f'text/{p}', s, b) for p, s, b in weights.lora_entries(
            mods['text_encoder'], lambda p: '/attn/' in p, lora['rank'])]
        out += [(f'unet/{p}', s, b) for p, s, b in weights.lora_entries(
            mods['unet'], lambda p: '/attn1/' in p or '/attn2/' in p,
            lora['rank'])]
    return out


def draw_all(cfg, seed, device, dtype):
    """{model: {name: tensor}}, and the extras: the concept table and the
    text and UNet LoRA trees (None without LoRA)."""
    mods = reference_modules(cfg)
    out = {}
    for name, mod in mods.items():
        out[name] = weights.draw(weights.plan(mod),
                                 weights.generator(device, seed,
                                                   STREAMS[name]),
                                 device, dtype)
    extras = weights.draw(_extras_entries(cfg, mods),
                          weights.generator(device, seed, STREAMS['extras']),
                          device, dtype)
    table = extras.pop('concepts')
    trees = weights.lora_tree(extras)
    return out, table, trees.get('text'), trees.get('unet')


@dataclasses.dataclass
class System:
    """One side's models. For the program `tokenizer` is its CLIPTokenizer
    and `new_concept_cfg` its concept config; for the reference they are
    {token: id} and {concept: [its layer tokens]} (concept_tokens)."""
    unet: torch.nn.Module
    text_encoder: torch.nn.Module
    vae: torch.nn.Module
    adapter: object
    tokenizer: object
    new_concept_cfg: dict
    concept_table: torch.Tensor
    text_lora: object
    unet_lora: object


def program(cfg, seed, device, dtype=torch.bfloat16) -> System:
    """The port's modules of `cfg`, filled from the seed's draws."""
    from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextConfig,
                                            CLIPTextModel, UNet, UNetConfig,
                                            VAEConfig)
    from mixofshow_tpu_torch.models.t2i_adapter import (T2IAdapter,
                                                        T2IAdapterConfig)
    from mixofshow_tpu_torch.text import CLIPTokenizer

    u = dict(cfg['unet'])
    u['block_out_channels'] = tuple(u['block_out_channels'])
    u['down_cross'] = tuple(u['down_cross'])
    v = dict(cfg['vae'])
    v['block_out_channels'] = tuple(v['block_out_channels'])
    mods = {'unet': UNet(UNetConfig(**u), 'meta', dtype),
            'text_encoder': CLIPTextModel(
                CLIPTextConfig(**cfg['text_encoder']), 'meta', dtype),
            'vae': AutoencoderKL(VAEConfig(**v), 'meta', dtype)}
    if 'adapter' in cfg:
        a = dict(cfg['adapter'])
        a['channels'] = tuple(a['channels'])
        mods['adapter'] = T2IAdapter(T2IAdapterConfig(**a), 'meta', dtype)
    drawn, table, text_lora, unet_lora = draw_all(cfg, seed, device, dtype)
    for name, mod in mods.items():
        mod.load_state_dict(drawn[name], strict=True, assign=True)
        mod.requires_grad_(False).eval()
    tok = CLIPTokenizer()
    names, ids = concept_tokens(cfg)
    new_cfg = {}
    for concept, toks in names.items():
        if tok.add_tokens(toks) != len(toks):
            raise ValueError(f'{concept}: tokens already present')
        new_cfg[concept] = {
            'concept_token_ids': [tok.convert_tokens_to_ids(t)
                                  for t in toks],
            'concept_token_names': toks}
        if new_cfg[concept]['concept_token_ids'] != [ids[t] for t in toks]:
            raise ValueError(f'{concept}: the tokenizer numbered its tokens '
                             f'otherwise than the benchmark')
    return System(mods['unet'], mods['text_encoder'], mods['vae'],
                  mods.get('adapter'), tok, new_cfg, table, text_lora,
                  unet_lora)


def reference(cfg, seed, device) -> System:
    """The reference's modules of `cfg`, in float32, from the same draws."""
    mods = reference_modules(cfg)
    drawn, table, text_lora, unet_lora = draw_all(cfg, seed, device,
                                                  torch.float32)
    for name, mod in mods.items():
        mod.load_state_dict(drawn[name], strict=True, assign=True)
        mod.requires_grad_(False).eval()
    names, ids = concept_tokens(cfg)
    return System(mods['unet'], mods['text_encoder'], mods['vae'],
                  mods.get('adapter'), ids, names, table, text_lora,
                  unet_lora)
