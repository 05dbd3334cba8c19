#!/usr/bin/env python
"""fp32 output parity of the PyTorch port against the JAX package's
`tools/parity_check.py`, on one checkpoint directory.

The port's side of the fixed-latent protocol of tools/parity_check.py
(reference test_edlora.py:24-57): PromptDataset's torch-seeded per-index
latents, NEGATIVE_PROMPT, DPM-Solver++ at the given guidance and steps,
images named `{prompt with spaces->_}---G_{g}_S_{steps}---{idx:02d}`. The
same three checkpoint modes: a base diffusers directory (`--pretrained`),
base + an ED-LoRA delta (`--delta`, at `--alpha`), or a fused directory
with its new_concept_cfg.json (`--fused`). It either writes its fp32
outputs (`--emit DIR`: `<name>.npy` in [0, 1] and a `.png` preview) or
compares them with stored ones (`--ref-dir DIR`, e.g. what
`tools/parity_check.py --emit` wrote from the JAX package): per image the
largest and mean absolute difference against `--max-tol` / `--mean-tol`.

    python tools/parity_check.py --pretrained CKPT --prompts "a dog" \
        --emit OUT                                  # the JAX package
    python tools/port_parity_check.py --pretrained CKPT --prompts "a dog" \
        --ref-dir OUT --device cpu                  # the port

Model widths come from each model's config.json (SD1.5's without one);
`--model-size` must name the UNet's width family. `random:sd15` and
`random:tiny` work as `--pretrained`, with the port's own random weights
(not the JAX package's). Imports torch, numpy and the port only.

Exit code 0 when emitting or when every compared image passes, 1 on any
failed comparison. The report is one JSON document on stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from mixofshow_tpu_torch import zoo  # noqa: E402
from mixofshow_tpu_torch.convert.delta_io import (  # noqa: E402
    convert_edlora_delta, load_edlora_delta)
from mixofshow_tpu_torch.data import PromptDataset  # noqa: E402
from mixofshow_tpu_torch.diffusion import DPMSolverMultistep  # noqa: E402
from mixofshow_tpu_torch.models import UNetConfig  # noqa: E402
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,  # noqa: E402
                                           init_concepts)
from mixofshow_tpu_torch.utils.device import exact_fp32  # noqa: E402
from mixofshow_tpu_torch.utils.options import NEGATIVE_PROMPT  # noqa: E402
from mixofshow_tpu_torch.utils.vis import (array_to_pil,  # noqa: E402
                                           pil_imwrite, safe_filename)

SIZES = {'sd15': UNetConfig.sd15(), 'tiny': zoo.tiny_configs()[0]}


def protocol_name(prompt: str, guidance: float, steps: int, idx: int) -> str:
    stem = safe_filename(prompt.replace(' ', '_'))
    return f'{stem}---G_{guidance}_S_{steps}---{idx:02d}'


def _scheduler(root: str) -> DPMSolverMultistep:
    """The directory's prediction type (scheduler_config.json), epsilon
    without one, as the JAX loader reads it."""
    pred = 'epsilon'
    path = os.path.join(root, 'scheduler', 'scheduler_config.json')
    if os.path.exists(path):
        with open(path) as f:
            pred = json.load(f).get('prediction_type', pred)
    return DPMSolverMultistep.create(prediction_type=pred)


def build_pipeline(args, device) -> EDLoRAPipeline:
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[args.dtype]
    root = args.fused or args.pretrained
    bundle = zoo.load_models(root, device, seed=0, dtype=dtype)
    want = SIZES[args.model_size].block_out_channels
    if bundle.unet.cfg.block_out_channels != want:
        raise ValueError(f'{root}: UNet widths '
                         f'{bundle.unet.cfg.block_out_channels}, '
                         f'--model-size {args.model_size} is {want}')
    mods = (bundle.unet, bundle.text_encoder, bundle.vae, bundle.tokenizer,
            device, dtype)
    sched = _scheduler(root) if os.path.isdir(root) else None
    if args.fused:
        with open(os.path.join(root, 'new_concept_cfg.json')) as f:
            cfg = json.load(f)
        return EDLoRAPipeline(*mods, scheduler=sched, new_concept_cfg=cfg)
    if not args.delta:   # base SD: no concepts, 16 identical layer prompts
        return EDLoRAPipeline(*mods, scheduler=sched, new_concept_cfg={})
    # base + delta: the concept names come from the delta, registered as
    # test_edlora does
    delta = convert_edlora_delta(load_edlora_delta(args.delta))
    cfg, _ = init_concepts(bundle.tokenizer,
                           '+'.join(delta['new_concept_embedding']), None,
                           bundle.text_encoder.token_embedding.weight)
    table = torch.cat([delta['new_concept_embedding'][n] for n in cfg])
    return EDLoRAPipeline(*mods, scheduler=sched, new_concept_cfg=cfg,
                          concept_embedding=table,
                          unet_lora=delta['unet_lora'] or None,
                          text_lora=delta['text_lora'] or None,
                          lora_alpha=args.alpha)


def _load_ref(path_base: str):
    """A stored output: fp32 .npy (H, W, 3 in [0, 1]), else an 8-bit .png."""
    if os.path.exists(path_base + '.npy'):
        return np.load(path_base + '.npy').astype(np.float32), 'npy'
    if os.path.exists(path_base + '.png'):
        from PIL import Image
        arr = np.asarray(Image.open(path_base + '.png').convert('RGB'))
        return arr.astype(np.float32) / 255.0, 'png'
    return None, None


def compare(img, ref_dir, name, max_tol, mean_tol):
    ref, kind = _load_ref(os.path.join(ref_dir, name))
    if ref is None:
        return {'compared': False, 'error': 'no reference output found',
                'pass': False}
    if ref.shape != img.shape:
        return {'compared': False, 'pass': False,
                'error': f'shape {list(ref.shape)} vs {list(img.shape)}'}
    diff = np.abs(ref - img)
    mse = float((diff ** 2).mean())
    # an 8-bit reference quantizes at 1/510 mean error
    mean_tol = mean_tol + (1 / 510 if kind == 'png' else 0.0)
    return {'compared': True, 'ref_format': kind,
            'max_abs': float(diff.max()), 'mean_abs': float(diff.mean()),
            'psnr_db': float(10 * np.log10(1.0 / mse)) if mse else 99.0,
            'pass': float(diff.max()) <= max_tol and
            float(diff.mean()) <= mean_tol}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--pretrained', help='diffusers SD1.x checkpoint dir')
    ap.add_argument('--delta', help='reference ED-LoRA delta .pth')
    ap.add_argument('--fused', help='fused/combined checkpoint dir '
                                    '(overrides --pretrained/--delta)')
    ap.add_argument('--prompts', nargs='+', required=True,
                    help='prompt strings, or one path to a prompt file')
    ap.add_argument('--ref-dir', help='stored reference outputs to compare')
    ap.add_argument('--emit', help='write the port\'s outputs here')
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--guidance', type=float, default=7.5)
    ap.add_argument('--height', type=int, default=512)
    ap.add_argument('--width', type=int, default=512)
    ap.add_argument('--samples-per-prompt', type=int, default=1)
    ap.add_argument('--alpha', type=float, default=1.0,
                    help='LoRA alpha for --delta mode')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--dtype', default='float32',
                    choices=['float32', 'bfloat16'])
    ap.add_argument('--model-size', default='sd15', choices=['sd15', 'tiny'],
                    help='the UNet width family the checkpoint must have')
    ap.add_argument('--max-tol', type=float, default=0.10,
                    help='per-pixel max-abs failure threshold')
    ap.add_argument('--mean-tol', type=float, default=0.01,
                    help='mean-abs failure threshold')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if not (args.fused or args.pretrained):
        ap.error('need --pretrained or --fused')
    if not (args.ref_dir or args.emit):
        ap.error('need --ref-dir (compare) and/or --emit (record)')

    device = torch.device(args.device)
    if device.type == 'cuda':
        exact_fp32()   # the parity protocol is fp32, not TF32
    prompts = args.prompts
    if len(prompts) == 1 and os.path.exists(prompts[0]):
        prompts = prompts[0]   # PromptDataset reads the file itself
    dataset = PromptDataset({
        'prompts': prompts if isinstance(prompts, str) else list(prompts),
        'num_samples_per_prompt': args.samples_per_prompt,
        'latent_size': (4, args.height // 8, args.width // 8),
        'share_latent_across_prompt': True})
    pipe = build_pipeline(args, device)
    report = {
        'protocol': 'fixed-latent (PromptDataset torch-seeded noise), '
                    f'{args.steps} steps, G={args.guidance}, '
                    f'negative_prompt=NEGATIVE_PROMPT, dtype={args.dtype}',
        'checkpoint': {'pretrained': args.pretrained, 'delta': args.delta,
                       'fused': args.fused, 'alpha': args.alpha},
        'device': str(device),
        'device_kind': torch.cuda.get_device_name(device)
        if device.type == 'cuda' else 'cpu',
        'torch_version': torch.__version__, 'images': []}
    if args.emit:
        os.makedirs(args.emit, exist_ok=True)
    items = [dataset[i] for i in range(len(dataset))]
    n_pass = n_fail = 0
    for i in range(0, len(items), args.batch):
        chunk = items[i:i + args.batch]
        imgs = pipe([c['prompts'] for c in chunk], height=args.height,
                    width=args.width, num_inference_steps=args.steps,
                    guidance_scale=args.guidance,
                    negative_prompt=[NEGATIVE_PROMPT] * len(chunk),
                    latents=np.stack([c['latents'] for c in chunk]),
                    output_type='np')
        for c, img in zip(chunk, imgs):
            name = protocol_name(c['prompts'], args.guidance, args.steps,
                                 int(c['indices']))
            entry = {'name': name}
            if args.emit:
                np.save(os.path.join(args.emit, name + '.npy'), img)
                pil_imwrite(array_to_pil(img),
                            os.path.join(args.emit, name + '.png'))
                entry['emitted'] = True
            if args.ref_dir:
                entry.update(compare(img, args.ref_dir, name, args.max_tol,
                                     args.mean_tol))
                n_pass += entry['pass']
                n_fail += not entry['pass']
            report['images'].append(entry)
    if args.ref_dir:
        compared = [e for e in report['images'] if e.get('compared')]
        report['summary'] = {
            'pass': n_pass, 'fail': n_fail, 'all_pass': n_fail == 0,
            'max_abs': max((e['max_abs'] for e in compared), default=None),
            'mean_abs': float(np.mean([e['mean_abs'] for e in compared]))
            if compared else None}
    print(json.dumps(report, indent=1))
    return 1 if (args.ref_dir and n_fail) else 0


if __name__ == '__main__':
    sys.exit(main())
