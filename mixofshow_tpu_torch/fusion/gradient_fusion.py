"""Gradient fusion: merge N concept ED-LoRAs into one base checkpoint.

Port of mixofshow_tpu/fusion/gradient_fusion.py (the reference's
center-node fusion, gradient_fusion.py:750-813): the same four phases in the
same order, each capturing features with the previous phases' merged
weights:
  1. concept embeddings -> one concatenated concept table + new_concept_cfg;
  2. text encoder -> an anchored least-squares fit per LoRA'd attention
     linear, on Grams captured while encoding each concept's prompts;
  3. UNet cross-KV -> a fit per to_k/to_v on that layer's concept text
     features;
  4. UNet spatial linears -> a fit on Grams captured during a 20-step
     DPM-Solver++ denoise per concept (UNet in bf16, fp32 latents, fp32
     Grams, batch 1, no CFG).
Targets are G @ Wm, so no activation is kept, only Grams (ops/solve.py). The
spatial phase's UNet self-attentions with >= 1024 keys run the flash forward
(K4) through `layers.sdpa`, as the JAX package's do.

Layouts: the solve works in the (in, out) kernel layout with (F, F) Grams,
like the JAX package. The port's Linear holds (out, in) and its 1x1 Conv2d
(out, in, 1, 1); a LoRA delta is alpha · up @ down, (out, in). `_lora_delta`
and the anchors transpose into the solve's layout, `_apply_kernels`
transposes back and restores the conv shape.

The modules are updated IN PLACE (an SD1.5 UNet copy per phase would double
its memory): after `compose_concepts` the bundle is the fused model, its text
encoder's token table grown by the concept rows. All products run in full
fp32 (`fp32_matmuls`), restored afterwards.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mixofshow_tpu_torch.convert.delta_io import (convert_edlora_delta,
                                                  load_edlora_delta)
from mixofshow_tpu_torch.convert.diffusers_export import save_pipeline_params
from mixofshow_tpu_torch.diffusion import DPMSolverMultistep
from mixofshow_tpu_torch.models import UNet
from mixofshow_tpu_torch.models.lora import flatten_lora, get_module, set_path
from mixofshow_tpu_torch.models.unet import cross_layer_paths
from mixofshow_tpu_torch.ops.solve import gram, solve_layer_group
from mixofshow_tpu_torch.pipelines.concepts import (NUM_CROSS_ATTENTION_LAYERS,
                                                    bind_concept_prompt)
from mixofshow_tpu_torch.text.tokenizer import EOS_TOKEN_ID
from mixofshow_tpu_torch.utils.device import fp32_matmuls

logger = logging.getLogger('mixofshow_tpu_torch')

TEMPLATE_SIMPLE = 'photo of a {}'


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


# --------------------------------------------------------------- parsing
def parse_new_concepts(concept_cfg: str, device):
    """Load every concept's delta, split the UNet LoRA into cross-KV
    (attn2 to_k/to_v) and spatial groups (reference parse_new_concepts,
    gradient_fusion.py:270-322)."""
    with open(concept_cfg) as f:
        concept_list = json.load(f)
    parsed = []
    for concept in concept_list:
        delta = convert_edlora_delta(load_edlora_delta(concept['lora_path']),
                                     device)
        crosskv: Dict = {}
        spatial: Dict = {}
        for path, leaf in flatten_lora(delta['unet_lora']).items():
            target = crosskv if ('/attn2/to_k' in path or
                                 '/attn2/to_v' in path) else spatial
            set_path(target, path, leaf)
        parsed.append({'embedding': delta['new_concept_embedding'],
                       'text_lora': delta['text_lora'],
                       'unet_crosskv': crosskv, 'unet_spatial': spatial})
    return parsed, concept_list


def merge_new_concepts(parsed, concept_list, tokenizer):
    """Phase 1: register every concept's 16 tokens and stack their rows
    into one table (reference merge_new_concepts_, :217-267). Returns
    (new_concept_cfg, table (n_tokens, C) fp32)."""
    new_concept_cfg: Dict = {}
    rows: List[torch.Tensor] = []
    start_idx = 0
    for data, concept in zip(parsed, concept_list):
        for concept_name in concept['concept_name'].split(' '):
            if not concept_name.startswith('<'):
                continue
            if concept_name not in data['embedding']:
                raise KeyError(f'concept {concept_name} not found in its '
                               'lora checkpoint')
            names = [f'<new{start_idx + i}>'
                     for i in range(NUM_CROSS_ATTENTION_LAYERS)]
            if tokenizer.add_tokens(names) != NUM_CROSS_ATTENTION_LAYERS:
                raise ValueError(f'tokens of {concept_name} already exist')
            ids = [tokenizer.convert_tokens_to_ids(n) for n in names]
            rows.append(torch.as_tensor(data['embedding'][concept_name],
                                        dtype=torch.float32))
            new_concept_cfg[concept_name] = {'concept_token_ids': ids,
                                             'concept_token_names': names}
            logger.info('concept %s bound to token ids [%d, %d]',
                        concept_name, min(ids), max(ids))
            start_idx += NUM_CROSS_ATTENTION_LAYERS
    table = torch.cat(rows) if rows else torch.zeros((0, 768))
    return new_concept_cfg, table


# ----------------------------------------------------------- shared parts
def _lora_delta(leaf, alpha: float):
    """alpha · (up @ down)ᵀ = alpha · downᵀ @ upᵀ: one LoRA leaf's (in, out)
    weight delta, or None when the concept has no adapter there (the solve
    then pulls that layer toward the anchor)."""
    if leaf is None:
        return None
    return alpha * (leaf['down'].float().T @ leaf['up'].float().T)


def layer_kernel(module: nn.Module, path: str) -> torch.Tensor:
    """The (in, out) fp32 kernel of the Linear or 1x1 Conv2d at `path`."""
    w = get_module(module, path).weight
    return w.detach().reshape(w.shape[0], -1).T.float()


@torch.no_grad()
def _apply_kernels(module: nn.Module, kernels: Dict[str, torch.Tensor]):
    """Write solved (in, out) kernels back as (out, in) weights, in place;
    a 1x1 conv gets its (out, in, 1, 1) shape back."""
    for path, kern in kernels.items():
        w = get_module(module, path).weight
        w.copy_(kern.T.reshape(w.shape))


def _accumulate(g_sums, d_sums, path, g, dm):
    g_sums[path] = g if g_sums.get(path) is None else g_sums[path] + g
    if dm is not None:
        d = g @ dm
        d_sums[path] = d if d_sums.get(path) is None else d_sums[path] + d


def _solve(tag, module, paths, g_sums, d_sums, lam, method, iters):
    """Solve the given layers, write them into `module`, log residuals;
    returns ({path: solved (in, out)}, {path: residual core}, {path: summed
    Gram})."""
    anchors = [layer_kernel(module, p) for p in paths]
    deltas = [d_sums[p] if d_sums.get(p) is not None else torch.zeros_like(a)
              for p, a in zip(paths, anchors)]
    solved, residuals = solve_layer_group(
        [g_sums[p] for p in paths], deltas, anchors, lam=lam, method=method,
        iters=iters, with_residuals=True)
    kernels = dict(zip(paths, solved))
    _apply_kernels(module, kernels)
    _log_residuals(tag, paths, residuals)
    return kernels, dict(zip(paths, residuals)), \
        {p: g_sums[p] for p in paths}


def _log_residuals(tag: str, paths, residuals):
    """Per-layer fit residual Σ_c‖X_c(Wn − Wm_c)‖² up to the Wn-independent
    constant, the diagnostic the reference logs after LBFGS
    (gradient_fusion.py:87-95)."""
    for path, r in zip(paths, residuals):
        logger.info('%s %s: residual(core)=%.3e', tag, path, r)


def _token_ids(tokenizer, prompts, device):
    return torch.from_numpy(np.asarray(tokenizer(prompts), np.int64)).to(
        device)


# ----------------------------------------------------------- phase 2: text
_CLIP_POINT = {'q': 'qkv', 'k': 'qkv', 'v': 'qkv', 'out': 'out'}


@torch.no_grad()
def merge_text_encoder(parsed, concept_list, new_concept_cfg, tokenizer,
                       text_encoder, concept_table, lam: float = 1e-4,
                       method: str = 'exact', iters: int = 500):
    """Phase 2 (reference :460-576): per concept, the Grams of every LoRA'd
    linear's input while encoding its bound prompts through the concept's
    LoRA'd text encoder (rows up to and including the first eos, as the
    reference's do_not_pad); each layer solved against the concept-merged
    weights. Updates `text_encoder` in place; returns ({path: (in, out)
    kernel}, {path: residual}, {path: summed Gram})."""
    layer_paths = sorted({p for data in parsed
                          for p in flatten_lora(data['text_lora'])})
    if not layer_paths:
        return {}, {}, {}
    logger.info('text_encoder: %d linear layers to optimize',
                len(layer_paths))
    dev = _device_of(text_encoder)
    table = concept_table.to(dev)
    g_sums: Dict = {}
    d_sums: Dict = {}
    with fp32_matmuls():
        for data, concept in zip(parsed, concept_list):
            prompts = [TEMPLATE_SIMPLE.format(concept['concept_name']),
                       concept['concept_name']]
            ids = _token_ids(tokenizer, bind_concept_prompt(
                prompts, new_concept_cfg), dev)
            first_eos = (ids == EOS_TOKEN_ID).int().argmax(1)
            mask = torch.arange(ids.shape[1], device=dev)[None] <= \
                first_eos[:, None]
            alpha = float(concept.get('text_encoder_alpha', 1.0))
            _, grams = text_encoder(ids, table, data['text_lora'] or None,
                                    alpha, capture_grams=True,
                                    token_mask=mask)
            lora_flat = flatten_lora(data['text_lora'])
            for path in layer_paths:
                _, blk, _, proj = path.split('/')
                _accumulate(g_sums, d_sums, path,
                            grams[int(blk)][_CLIP_POINT[proj]],
                            _lora_delta(lora_flat.get(path), alpha))
        return _solve('text_encoder', text_encoder, layer_paths, g_sums,
                      d_sums, lam, method, iters)


# ------------------------------------------------------- phase 3: cross-KV
def _category_rows(ids: np.ndarray) -> List[int]:
    """Positions with token id >= eos up to and including the first eos:
    the concept tokens and the end token (reference get_text_feature
    'category_embedding', :183-204)."""
    first_eos = int((ids == EOS_TOKEN_ID).argmax())
    return [i for i in range(first_eos + 1) if ids[i] >= EOS_TOKEN_ID]


@torch.no_grad()
def category_embedding(text_encoder, concept_table, ids_row):
    """The final hidden states of one prompt's category rows."""
    ids = np.asarray(ids_row)
    dev = _device_of(text_encoder)
    emb = text_encoder(torch.from_numpy(ids.astype(np.int64))[None].to(dev),
                       concept_table.to(dev))[0]
    return emb[_category_rows(ids)]


@torch.no_grad()
def merge_kv_in_cross_attention(parsed, concept_list, new_concept_cfg,
                                tokenizer, text_encoder, concept_table, unet,
                                lam: float = 1e-4, method: str = 'exact',
                                iters: int = 500):
    """Phase 3 (reference :325-457): the 2 x 16 to_k/to_v layers in
    down→mid→up order; a layer's inputs are its concept text features
    (phase-2-merged text encoder), the target the concept-merged KV applied
    to them. Updates `unet` in place."""
    kv_paths = []
    for layer_idx, prefix in enumerate(cross_layer_paths(unet.cfg)):
        kv_paths += [(layer_idx, f'{prefix}/attn2/to_k'),
                     (layer_idx, f'{prefix}/attn2/to_v')]
    logger.info('unet: %d cross-KV linear layers to optimize', len(kv_paths))
    dev = _device_of(text_encoder)
    table = concept_table.to(dev)
    g_sums: Dict = {}
    d_sums: Dict = {}
    with fp32_matmuls():
        for data, concept in zip(parsed, concept_list):
            if not data['unet_crosskv']:
                continue
            prompts = [TEMPLATE_SIMPLE.format(concept['concept_name']),
                       concept['concept_name']]
            ids = np.asarray(tokenizer(bind_concept_prompt(
                prompts, new_concept_cfg)))
            alpha = float(concept.get('unet_alpha', 1.0))
            lora_flat = flatten_lora(data['unet_crosskv'])
            emb_all = text_encoder(
                torch.from_numpy(ids.astype(np.int64)).to(dev), table)
            feats = {}
            for layer_idx in range(NUM_CROSS_ATTENTION_LAYERS):
                rows = [j * NUM_CROSS_ATTENTION_LAYERS + layer_idx
                        for j in range(len(prompts))]
                feats[layer_idx] = torch.cat(
                    [emb_all[r][_category_rows(ids[r])] for r in rows]).float()
            for layer_idx, path in kv_paths:
                _accumulate(g_sums, d_sums, path, gram(feats[layer_idx]),
                            _lora_delta(lora_flat.get(path), alpha))
        active = [p for _, p in kv_paths if g_sums.get(p) is not None]
        if not active:
            return {}, {}, {}
        return _solve('unet cross-KV', unet, active, g_sums, d_sums, lam,
                      method, iters)


# ------------------------------------------------------ phase 4: spatial
# leaf (relative to the transformer's path) -> UNet gram capture point
_UNET_POINT = {'attn1/to_q': 'attn1_qkv', 'attn1/to_k': 'attn1_qkv',
               'attn1/to_v': 'attn1_qkv', 'attn1/to_out': 'attn1_out',
               'attn2/to_q': 'attn2_q', 'attn2/to_out': 'attn2_out',
               'ff/proj': 'ff_in', 'ff/out': 'ff_out',
               'proj_in': 'proj_in', 'proj_out': 'proj_out'}


def _split_spatial_path(path: str, prefix_to_idx):
    """'down_blocks/0/attentions/1/attn1/to_q' -> (layer_idx, 'attn1/to_q');
    proj_in/proj_out split one level up."""
    if path.endswith(('proj_in', 'proj_out')):
        prefix, leaf = path.rsplit('/', 1)
    else:
        prefix = path.rsplit('/', 2)[0]
        leaf = '/'.join(path.split('/')[-2:])
    return prefix_to_idx.get(prefix), leaf


def _cast_copy(unet: UNet, dtype) -> UNet:
    """A copy of `unet` in `dtype` on its device, made without a second
    copy in the source dtype."""
    dev = _device_of(unet)
    out = UNet(unet.cfg, 'meta', dtype).to_empty(device=dev)
    out.load_state_dict(unet.state_dict())
    return out.eval()


@torch.no_grad()
def merge_spatial_attention(parsed, concept_list, new_concept_cfg, tokenizer,
                            text_encoder, concept_table, unet,
                            scheduler=None, num_inference_steps: int = 20,
                            record_nums: int = 20, image_size: int = 512,
                            seed: int = 0, lam: float = 1e-4,
                            method: str = 'exact', iters: int = 50,
                            compute_dtype=torch.bfloat16,
                            latents: Optional[Sequence] = None):
    """Phase 4 (reference :627-747): per concept, a `num_inference_steps`
    DPM-Solver++ denoise of 'photo of a <concept>' at batch 1, no CFG, with
    the concept's spatial LoRA applied, summing the spatial linears' input
    Grams at the recorded steps; solved anchored at the phase-3 weights.
    The UNet runs as a `compute_dtype` copy; latents are fp32, from a
    torch.Generator on the UNet's device seeded `seed + ci` for concept ci,
    unless `latents[ci]` ((1, 4, h, w)) is given. Updates `unet` in place."""
    layer_paths = sorted({p for data in parsed
                          for p in flatten_lora(data['unet_spatial'])})
    if not layer_paths:
        return {}, {}, {}
    logger.info('unet: %d spatial linear layers to optimize',
                len(layer_paths))
    prefix_to_idx = {p: i for i, p in enumerate(cross_layer_paths(unet.cfg))}
    # only the points some delta needs (ff grams are (4c, 4c))
    points = tuple(sorted({
        _UNET_POINT[leaf] for _, leaf in
        (_split_spatial_path(p, prefix_to_idx) for p in layer_paths)
        if leaf in _UNET_POINT}))
    scheduler = scheduler or DPMSolverMultistep.create()
    coeffs = scheduler.step_coeffs(num_inference_steps)
    n = num_inference_steps
    stride = max(n // record_nums, 1)
    record = np.zeros((n,), np.float32)
    record[np.arange(0, n, stride)[:record_nums]] = 1.0

    dev = _device_of(unet)
    lat = image_size // 8
    unet_c = unet if unet.conv_in.weight.dtype == compute_dtype else \
        _cast_copy(unet, compute_dtype)
    table = concept_table.to(dev)
    g_sums: Dict = {}
    d_sums: Dict = {}
    with fp32_matmuls():
        for ci, (data, concept) in enumerate(zip(parsed, concept_list)):
            if not data['unet_spatial']:
                continue
            prompt = TEMPLATE_SIMPLE.format(concept['concept_name'])
            ids = _token_ids(tokenizer, bind_concept_prompt(
                [prompt], new_concept_cfg), dev)
            embeds = text_encoder(ids, table).reshape(
                1, NUM_CROSS_ATTENTION_LAYERS, -1,
                text_encoder.cfg.width).to(compute_dtype)
            if latents is not None:
                sample = torch.as_tensor(latents[ci]).to(dev, torch.float32)
            else:
                g = torch.Generator(device=dev).manual_seed(seed + ci)
                sample = torch.randn((1, 4, lat, lat), generator=g,
                                     device=dev, dtype=torch.float32)
            alpha = float(concept.get('unet_alpha', 1.0))
            lora = data['unet_spatial'] or None
            m_prev = torch.zeros_like(sample)
            gsum: Dict = {}
            for i in range(n):
                t = torch.full((1,), int(coeffs.timestep[i]), device=dev)
                eps, aux = unet_c(sample.to(compute_dtype), t, embeds, lora,
                                  alpha, capture_grams=points)
                if record[i]:
                    for idx, grams in aux['grams'].items():
                        acc = gsum.setdefault(idx, {})
                        for point, gm in grams.items():
                            acc[point] = gm if point not in acc else \
                                acc[point] + gm
                sample, m_prev = scheduler.step(sample, m_prev, eps.float(),
                                                coeffs, i)
            lora_flat = flatten_lora(data['unet_spatial'])
            for path in layer_paths:
                layer_idx, leaf = _split_spatial_path(path, prefix_to_idx)
                point = _UNET_POINT.get(leaf)
                if layer_idx is None or point is None:
                    logger.warning('no capture point for %s — skipped', path)
                    continue
                _accumulate(g_sums, d_sums, path, gsum[layer_idx][point],
                            _lora_delta(lora_flat.get(path), alpha))
        del unet_c
        active = [p for p in layer_paths if g_sums.get(p) is not None]
        return _solve('unet spatial', unet, active, g_sums, d_sums, lam,
                      method, iters)


# ------------------------------------------------------- all four phases
def compose_concepts(concept_cfg: str, pretrained_path: str, save_path: str,
                     device, suffix: str = 'base',
                     optimize_textenc_iters: int = 500,
                     optimize_unet_iters: int = 50,
                     lam_text: float = 1e-4, lam_unet: float = 1e-4,
                     spatial_steps: int = 20, image_size: int = 512,
                     seed: int = 0, bundle=None, solver: str = 'exact',
                     compute_dtype=torch.bfloat16,
                     latents: Optional[Sequence] = None,
                     report: Optional[Dict] = None):
    """The four phases, then a diffusers-layout checkpoint
    `<save_path>/combined_model_<suffix>` with new_concept_cfg.json
    (reference compose_concepts, :750-813). `bundle` (a zoo.ModelBundle in
    fp32) is fused in place; by default it is loaded from
    `pretrained_path` on `device`. solver='exact' is the batched spectral
    solve; 'lbfgs' the iterative parity path with the reference's
    iteration budgets (fuse.sh:8-9). `latents` goes to the spatial phase.
    A given `report` dict receives 'seconds' (each phase, the save, the
    whole, the device synchronised at each mark) and per phase ('text',
    'crosskv', 'spatial') the solved kernels, residuals and summed Grams.
    Returns (checkpoint dir, new_concept_cfg)."""
    t0 = time.perf_counter()
    last = [t0]
    seconds: Dict[str, float] = {}

    def mark(name, msg):
        if torch.cuda.is_available() and torch.device(device).type == 'cuda':
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if name is not None:
            seconds[name] = now - last[0]
        last[0] = now
        logger.info('%s [t+%.1fs]', msg, now - t0)

    if bundle is None:
        from mixofshow_tpu_torch.zoo import load_models
        bundle = load_models(pretrained_path, device, seed=seed)
    mark('load', '------Step 1/2: load base + concept checkpoints------')
    parsed, concept_list = parse_new_concepts(concept_cfg,
                                              _device_of(bundle.unet))
    mark('parse', '------Step 3: merge token embedding------')
    new_concept_cfg, table = merge_new_concepts(parsed, concept_list,
                                                bundle.tokenizer)
    mark('embedding', '------Step 4: merge text encoder------')
    phases = {}
    phases['text'] = merge_text_encoder(
        parsed, concept_list, new_concept_cfg, bundle.tokenizer,
        bundle.text_encoder, table, lam=lam_text, method=solver,
        iters=optimize_textenc_iters)
    mark('text', '------Step 5: merge kv of cross-attention in unet------')
    phases['crosskv'] = merge_kv_in_cross_attention(
        parsed, concept_list, new_concept_cfg, bundle.tokenizer,
        bundle.text_encoder, table, bundle.unet, lam=lam_text, method=solver,
        iters=optimize_textenc_iters)
    mark('crosskv', '------Step 6: merge spatial attention in unet------')
    phases['spatial'] = merge_spatial_attention(
        parsed, concept_list, new_concept_cfg, bundle.tokenizer,
        bundle.text_encoder, table, bundle.unet,
        num_inference_steps=spatial_steps, record_nums=spatial_steps,
        image_size=image_size, seed=seed, lam=lam_unet, method=solver,
        iters=optimize_unet_iters, compute_dtype=compute_dtype,
        latents=latents)
    ckpt_path = os.path.join(save_path, f'combined_model_{suffix}')
    mark('spatial', f'saving fused checkpoint to {ckpt_path}')
    # the concept rows join the token table, so the saved text encoder is a
    # plain checkpoint with a grown vocabulary (the reference saves its
    # resized embedding, gradient_fusion.py:230)
    te = bundle.text_encoder
    with torch.no_grad():
        grown = torch.cat([te.token_embedding.weight,
                           table.to(te.token_embedding.weight)])
    te.token_embedding = nn.Embedding.from_pretrained(grown, freeze=True)
    te.cfg = dataclasses.replace(te.cfg, vocab_size=grown.shape[0])
    save_pipeline_params(ckpt_path, unet=bundle.unet, vae=bundle.vae,
                         text_encoder=te, new_concept_cfg=new_concept_cfg)
    mark('save', 'fused checkpoint saved')
    seconds['total'] = time.perf_counter() - t0
    if report is not None:
        report['seconds'] = seconds
        report.update({name: dict(zip(('kernels', 'residuals', 'grams'),
                                      out)) for name, out in phases.items()})
    return ckpt_path, new_concept_cfg
