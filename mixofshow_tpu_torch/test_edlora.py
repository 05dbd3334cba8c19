"""ED-LoRA checkpoint validation CLI of the port (the alpha sweep).

    python -m mixofshow_tpu_torch.test_edlora -opt options/test/....yml \
        [--device cuda]
    torchrun --nproc_per_node N -m mixofshow_tpu_torch.test_edlora ...

Mirrors the JAX package's root `test_edlora.py` (reference `test_edlora.py
-opt ...`): load the base models, register the concept tokens as training
did, load the delta at `path.lora_path` (reference `edlora.pth` layout),
and at each alpha of `val.alpha_list` sample every validation prompt with
its per-index latent through an unmerged-LoRA EDLoRAPipeline in the
options' compute dtype, writing `results/<name>/visualization/
Alpha-<alpha>/` and its composed grid. Under torchrun the N processes
(one device each) split every sweep's batches and write the files one
process writes; rank 0 makes the directories, logs and composes the grids.

`main(argv)` runs in-process and returns {alpha: what visual_validation
returned}.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from mixofshow_tpu_torch.convert.delta_io import (convert_edlora_delta,
                                                  load_edlora_delta)
from mixofshow_tpu_torch.data import PromptDataset
from mixofshow_tpu_torch.pipelines import EDLoRAPipeline, init_concepts
from mixofshow_tpu_torch.pipelines.validation import visual_validation
from mixofshow_tpu_torch.parallel.mesh import close_mesh, make_mesh
from mixofshow_tpu_torch.utils.logging_utils import set_path_logger
from mixofshow_tpu_torch.utils.options import (load_options,
                                               resolve_compute_dtype,
                                               set_manual_seed)
from mixofshow_tpu_torch.zoo import load_models


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    opt = load_options(args.opt)
    mesh = make_mesh(args.device)
    try:
        return _sweep(opt, args, mesh)
    finally:
        close_mesh(mesh)


def _sweep(opt, args, mesh) -> Dict:
    seed = opt.get('manual_seed', 0)
    if opt.get('manual_seed') is not None:
        set_manual_seed(seed)
    logger = set_path_logger(opt, args.opt, is_train=False, mesh=mesh)
    device = mesh.device
    dtype = resolve_compute_dtype(opt)
    logger.info(f'device: {device}, compute dtype: {dtype}')

    bundle = load_models(opt['models'].get('pretrained_path'), device,
                         seed=seed, dtype=dtype)
    # register the concept tokens as training did, then load the delta
    new_concept_cfg, _ = init_concepts(
        bundle.tokenizer, opt['models']['new_concept_token'], None,
        bundle.text_encoder.token_embedding.weight,
        enable_edlora=opt['models'].get('enable_edlora', True))
    delta = convert_edlora_delta(load_edlora_delta(opt['path']['lora_path']))
    table = torch.cat([delta['new_concept_embedding'][name]
                       for name in new_concept_cfg])

    val_dataset = PromptDataset(opt['datasets']['val_vis'])
    outputs = {}
    for alpha in opt['val'].get('alpha_list', [1.0]):
        logger.info(f'validation at alpha={alpha}')
        pipe = EDLoRAPipeline(
            bundle.unet, bundle.text_encoder, bundle.vae, bundle.tokenizer,
            device, dtype, new_concept_cfg=new_concept_cfg,
            concept_embedding=table, unet_lora=delta['unet_lora'] or None,
            text_lora=delta['text_lora'] or None, lora_alpha=float(alpha))
        outputs[alpha] = visual_validation(pipe, val_dataset,
                                           f'Alpha-{alpha}', opt, mesh)
        logger.info(f'wrote {outputs[alpha]}')
    return outputs


if __name__ == '__main__':
    main()
