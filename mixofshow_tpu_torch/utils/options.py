"""YAML experiment config loading (port of mixofshow_tpu/utils/options.py;
the reference uses OmegaConf, train_edlora.py:31; plain yaml and dicts
suffice here)."""
from __future__ import annotations

import os
import random
from typing import Any, Dict

import numpy as np
import torch
import yaml


def load_options(path: str) -> Dict[str, Any]:
    with open(path) as f:
        opt = yaml.safe_load(f)
    opt['opt_path'] = os.path.abspath(path)
    return opt


def set_manual_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_compute_dtype(opt):
    """Map the config's mixed_precision to the compute dtype.

    The reference trains and samples in fp16 (8101....yml:3,
    test_edlora.py:93); the port, like the JAX package, computes in
    bfloat16, so 'fp16' maps to bf16 deliberately. 'no'/'fp32' keep
    float32 (the dtype the parity tests run)."""
    mp = str(opt.get('mixed_precision', 'bf16')).lower()
    return torch.bfloat16 if mp in ('bf16', 'fp16') else torch.float32


NEGATIVE_PROMPT = ('longbody, lowres, bad anatomy, bad hands, missing fingers,'
                   ' extra digit, fewer digits, cropped, worst quality,'
                   ' low quality')


def dict2str(opt, indent_level: int = 1) -> str:
    """Pretty-print a nested options dict for logs (reference
    util.py:122-140)."""
    msg = '\n'
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + f'{k}:['
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + f'{k}: {v}\n'
    return msg
