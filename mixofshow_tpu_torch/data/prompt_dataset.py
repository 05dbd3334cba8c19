"""Validation-prompt dataset with deterministic per-sample latents.

Port of mixofshow_tpu/data/prompt_dataset.py (reference `PromptDataset`,
mixofshow/data/prompt_dataset.py:9-67): prompts (a file or a list) times
num_samples_per_prompt, each sample carrying a latent seeded by its index,
so alpha sweeps share noise and grids are comparable across checkpoints.

Each latent is `torch.randn` after `torch.manual_seed(seed)`, exactly as the
JAX package draws it (and the reference, prompt_dataset.py:62-66), so both
packages validate from bit-identical noise. Note that `torch.manual_seed`
reseeds torch's global generator; the trainer draws from its own.
"""
from __future__ import annotations

import os
import random
import re
from typing import Dict, List

import numpy as np
import torch


def _seeded_latents(shape, seed: int) -> np.ndarray:
    g = torch.manual_seed(seed)
    return torch.randn(list(shape), generator=g).numpy()


class PromptDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        prompts = opt['prompts']
        if isinstance(prompts, list):
            pass
        elif os.path.exists(prompts):
            with open(prompts) as fr:
                prompts = [line.strip() for line in fr.readlines()]
        else:
            raise ValueError('prompts should be a prompt file path or '
                             'prompt list, please check!')

        replace_mapping = opt.get('replace_mapping', {})
        cleaned: List[str] = []
        for line in prompts:
            if not line.strip():
                continue
            for k, v in replace_mapping.items():
                line = line.replace(k, v)
            cleaned.append(re.sub(' +', ' ', line.strip()))
        self.prompts = cleaned

        self.num_samples_per_prompt = opt['num_samples_per_prompt']
        self.prompts_to_generate = [
            (p, i) for i in range(1, self.num_samples_per_prompt + 1)
            for p in self.prompts
        ]
        self.latent_size = tuple(opt['latent_size'])  # (4, 64, 64) NCHW
        self.share_latent_across_prompt = opt.get(
            'share_latent_across_prompt', True)

    def __len__(self) -> int:
        return len(self.prompts_to_generate)

    def __getitem__(self, index: int) -> Dict:
        prompt, indice = self.prompts_to_generate[index]
        seed = indice if self.share_latent_across_prompt else \
            random.randint(0, 1000)
        return {
            'prompts': prompt,
            'indices': indice,
            'latents': _seeded_latents(self.latent_size, seed),
        }
