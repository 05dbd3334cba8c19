"""Fold a trained ED-LoRA delta into base weights for deployment.

Port of mixofshow_tpu/convert/convert_edlora.py (reference `convert_edlora`,
mixofshow/utils/convert_edlora_to_diffusers.py:79-99): register the concept
tokens, collect the trained embeddings into a standalone table
(models/clip's `concept_embedding`), and merge every LoRA pair into the
dense weights at strength `alpha` (W += alpha · up @ down, :64-73) with
models/lora.merge_into. The merge is IN PLACE (a merged copy of an SD1.5
UNet would double its memory); sampling with unmerged LoRA needs no merge
at all (EDLoRAPipeline's `unet_lora`/`text_lora`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from mixofshow_tpu_torch.models import CLIPTextModel, UNet
from mixofshow_tpu_torch.models.lora import merge_into
from mixofshow_tpu_torch.pipelines.concepts import NUM_CROSS_ATTENTION_LAYERS
from mixofshow_tpu_torch.text.tokenizer import CLIPTokenizer


def convert_edlora(text_encoder: CLIPTextModel, unet: UNet,
                   tokenizer: CLIPTokenizer, delta: Dict,
                   enable_edlora: bool = True, alpha: float = 1.0
                   ) -> Tuple[CLIPTextModel, UNet, Dict, torch.Tensor]:
    """delta: the output of convert.convert_edlora_delta
    (new_concept_embedding / text_lora / unet_lora). Adds each concept's
    `<newN>` tokens to `tokenizer` after the ones it already has, merges
    the LoRA trees into the modules in place, and returns (text_encoder,
    unet, new_concept_cfg, concept_table (rows, C) fp32 on the CPU)."""
    n_layers = NUM_CROSS_ATTENTION_LAYERS if enable_edlora else 1
    new_concept_cfg: Dict = {}
    rows = []
    start = len(tokenizer.added_tokens)
    for concept_name, emb in delta.get('new_concept_embedding', {}).items():
        names = [f'<new{start + i}>' for i in range(n_layers)]
        if tokenizer.add_tokens(names) != n_layers:
            raise ValueError(f'tokens already present for {concept_name}')
        new_concept_cfg[concept_name] = {
            'concept_token_ids': [tokenizer.convert_tokens_to_ids(n)
                                  for n in names],
            'concept_token_names': names}
        rows.append(torch.as_tensor(emb).to('cpu', torch.float32)
                    .reshape(n_layers, -1))
        start += n_layers
    table = torch.cat(rows) if rows else torch.zeros(
        (0, text_encoder.cfg.width))
    if delta.get('text_lora'):
        merge_into(text_encoder, delta['text_lora'], alpha)
    if delta.get('unet_lora'):
        merge_into(unet, delta['unet_lora'], alpha)
    return text_encoder, unet, new_concept_cfg, table
