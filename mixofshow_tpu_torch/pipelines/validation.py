"""Validation sampling: fixed-latent prompt sweeps and composed grids.

Port of mixofshow_tpu/pipelines/validation.py (reference
`visual_validation`, test_edlora.py:24-57): sample every validation prompt
with its per-index latent, write one PNG a sample and compose a labelled
grid. The sweep is pipelined one deep over `EDLoRAPipeline.submit`: batch
i+1 is queued on the device before batch i is read back and written, so
tokenization, the copy to the host and the PNG encode overlap device work.
One device, so no batch is padded for a mesh.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from mixofshow_tpu_torch.data.loader import DataLoader, default_collate
from mixofshow_tpu_torch.pipelines.pipeline_edlora import EDLoRAPipeline
from mixofshow_tpu_torch.utils.options import NEGATIVE_PROMPT
from mixofshow_tpu_torch.utils.vis import (array_to_pil, compose_visualize,
                                           pil_imwrite, safe_filename)


def visual_validation(pipe: EDLoRAPipeline, val_dataset, suffix: str,
                      opt: Dict) -> str:
    """Sample every (prompt, index) pair of `val_dataset` into
    `<path.visualization>/<suffix>/`; returns the composed grid's path
    when `val.compose_visualize` is set, else the directory."""
    sample_cfg = opt['val'].get('sample', {})
    steps = sample_cfg.get('num_inference_steps', 50)
    guidance = sample_cfg.get('guidance_scale', 7.5)
    batch_size = opt['datasets']['val_vis'].get('batch_size_per_gpu', 4)
    vis_dir = os.path.join(opt['path']['visualization'], suffix)
    loader = DataLoader(val_dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False, collate_fn=default_collate)

    def drain(handle, batch):
        for img, prompt, idx in zip(handle.result(), batch['prompts'],
                                    batch['indices']):
            name = (f'{safe_filename(prompt)}---G_{guidance}_S_{steps}---'
                    f'{int(idx):02d}.png')
            pil_imwrite(array_to_pil(img), os.path.join(vis_dir, name))

    pending = None
    for batch in loader:
        latents = np.asarray(batch['latents'])
        prompts = list(batch['prompts'])
        handle = pipe.submit(prompts,
                             height=latents.shape[-2] * 8,
                             width=latents.shape[-1] * 8,
                             num_inference_steps=steps,
                             guidance_scale=guidance,
                             negative_prompt=[NEGATIVE_PROMPT] * len(prompts),
                             latents=latents, output_type='np')
        if pending is not None:
            drain(*pending)
        pending = (handle, batch)
    if pending is not None:
        drain(*pending)

    if opt['val'].get('compose_visualize'):
        return compose_visualize(vis_dir)
    return vis_dir
