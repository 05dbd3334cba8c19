"""Regionally controllable multi-concept sampling CLI of the port.

    python -m mixofshow_tpu_torch.regionally_controlable_sampling \
        --pretrained_model <fused dir> --keypose_condition pose.png \
        --keypose_adapter_path <adapter dir> --prompt '...' \
        --prompt_rewrite '[p]-*-[neg]-*-[box]|...' --seed 19 [--device cuda]

Mirrors the JAX package's root `regionally_controlable_sampling.py`
(reference regionally_controlable_sampling.py, regionally_sample.sh): every
argument with its default, plus `--device`. It loads a fused checkpoint
directory with its new_concept_cfg.json, rewrites the
'[p]-*-[neg]-*-[box]|...' region prompts (`prepare_text`), sizes the canvas
from the condition images (`--height`/`--width` only without them), samples
`--num_images_per_prompt` images of the layout with keypose and sketch
T2I-Adapter control, and writes
`<save_dir>/seed_<seed>/<prompt>---<suffix>---<hash>[---i].png` with the
config lines beside each as `.txt`; the hash is the sha256 of those lines,
so the same arguments give the same names as the JAX CLI.

Adapters load from local checkpoint directories in the diffusers or the
original TencentARC layout (`models.t2i_adapter.convert_t2i_adapter`); a
path that does not exist (or none) gets a seeded random adapter, with the
JAX CLI's notice. Model widths come from the directory's config.json files
(SD1.5's where there are none); `--model_size` picks the adapters' configs.
The initial noise comes from a torch.Generator seeded with `--seed`, so the
images differ from the JAX CLI's for the same seed.

`main(argv, report)` runs in-process; `report` (a dict) receives the
seconds of loading, sampling and saving and the written paths.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert.diffusers_import import (_find_weights,
                                                          load_state_dict)
from mixofshow_tpu_torch.models.t2i_adapter import convert_t2i_adapter
from mixofshow_tpu_torch.pipelines import RegionallyT2IAdapterPipeline
from mixofshow_tpu_torch.utils.device import COMPUTE_DTYPE, as_device


def load_adapter(path: Optional[str], kind: str, model_size: str, device,
                 dtype=COMPUTE_DTYPE):
    """A keypose or sketch adapter from a checkpoint directory (its weights
    file, or that of its `adapter/` subdirectory), or a seeded random one
    when the directory does not exist."""
    if path and os.path.isdir(path):
        weights = _find_weights(path) or _find_weights(
            os.path.join(path, 'adapter'))
        if weights is None:
            raise FileNotFoundError(f'no adapter weights in {path}')
        return convert_t2i_adapter(
            load_state_dict(weights), zoo.t2i_adapter_config(kind, model_size),
            device, dtype)
    print(f'adapter path {path!r} not found — random init (no hub '
          'egress in this environment)')
    return zoo.load_t2i_adapter(kind, model_size, device, seed=0,
                                dtype=dtype)


def build_model(pretrained_model: str, keypose_adapter_path=None,
                sketch_adapter_path=None, device='cuda',
                dtype=COMPUTE_DTYPE, model_size: str = 'sd15'):
    """The fused directory (UNet, text encoder with its concept rows and
    `<new{i}>` tokens, VAE, new_concept_cfg.json) and both adapters in a
    RegionallyT2IAdapterPipeline on `device`."""
    dev = as_device(device)
    cfg_json = os.path.join(pretrained_model, 'new_concept_cfg.json')
    if not os.path.exists(cfg_json):
        raise FileNotFoundError(f'missing {cfg_json}')
    with open(cfg_json) as f:
        new_concept_cfg = json.load(f)
    bundle = zoo.load_models(pretrained_model, dev, dtype=dtype)
    return RegionallyT2IAdapterPipeline(
        bundle.unet, bundle.text_encoder, bundle.vae, bundle.tokenizer, dev,
        dtype, new_concept_cfg=new_concept_cfg,
        keypose_adapter=load_adapter(keypose_adapter_path, 'keypose',
                                     model_size, dev, dtype),
        sketch_adapter=load_adapter(sketch_adapter_path, 'sketch',
                                    model_size, dev, dtype))


def prepare_text(prompt: str, region_prompts: str, height: int, width: int):
    """'[p]-*-[neg]-*-[box]|...' -> (context_prompt, [(p, neg, box), ...]):
    pixel boxes divided by the canvas height and width (no clipping), an
    empty box the whole canvas, and an empty entry (a trailing '|') ends
    the list (reference prepare_text, regionally_controlable_sampling.py
    :67-94, with literal_eval in place of eval)."""
    region_collection = []
    for region in region_prompts.split('|'):
        if region == '':
            break
        prompt_region, neg_prompt_region, pos = region.split('-*-')
        prompt_region = prompt_region.replace('[', '').replace(']', '')
        neg_prompt_region = neg_prompt_region.replace('[', '').replace(']', '')
        pos = ast.literal_eval(pos)
        if len(pos) == 0:
            pos = [0, 0, 1, 1]
        else:
            pos[0], pos[2] = pos[0] / height, pos[2] / height
            pos[1], pos[3] = pos[1] / width, pos[3] / width
        region_collection.append((prompt_region, neg_prompt_region, pos))
    return (prompt, region_collection)


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser('', add_help=False)
    parser.add_argument('--pretrained_model', required=True, type=str)
    parser.add_argument('--sketch_condition', default=None, type=str)
    parser.add_argument('--sketch_adaptor_weight', default=1.0, type=float)
    parser.add_argument('--region_sketch_adaptor_weight', default='', type=str)
    parser.add_argument('--keypose_condition', default=None, type=str)
    parser.add_argument('--keypose_adaptor_weight', default=1.0, type=float)
    parser.add_argument('--region_keypose_adaptor_weight', default='', type=str)
    parser.add_argument('--keypose_adapter_path', default=None, type=str)
    parser.add_argument('--sketch_adapter_path', default=None, type=str)
    parser.add_argument('--save_dir', default=None, type=str)
    parser.add_argument('--prompt', default='photo of a toy', type=str)
    parser.add_argument('--negative_prompt', default='', type=str)
    parser.add_argument('--prompt_rewrite', default='', type=str)
    parser.add_argument('--seed', default=16141, type=int)
    parser.add_argument('--suffix', default='', type=str)
    parser.add_argument('--height', default=None, type=int)
    parser.add_argument('--width', default=None, type=int)
    parser.add_argument('--num_inference_steps', default=50, type=int)
    parser.add_argument('--num_images_per_prompt', default=1, type=int,
                        help='batch N images of the layout through one '
                             'denoise loop (different noise per image)')
    parser.add_argument('--model_size', default='sd15', type=str,
                        choices=['sd15', 'tiny'])
    parser.add_argument('--device', default='cuda', type=str)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         report: Optional[Dict] = None):
    from PIL import Image
    args = parse_args(argv)
    report = {} if report is None else report

    t0 = time.perf_counter()
    pipe = build_model(args.pretrained_model, args.keypose_adapter_path,
                       args.sketch_adapter_path, device=args.device,
                       model_size=args.model_size)

    sketch_condition, width_sketch, height_sketch = None, 0, 0
    if args.sketch_condition and os.path.exists(args.sketch_condition):
        sketch_condition = Image.open(args.sketch_condition).convert('L')
        width_sketch, height_sketch = sketch_condition.size
        print('use sketch condition')
    else:
        print('skip sketch condition')

    keypose_condition, width_pose, height_pose = None, 0, 0
    if args.keypose_condition and os.path.exists(args.keypose_condition):
        keypose_condition = Image.open(args.keypose_condition).convert('RGB')
        width_pose, height_pose = keypose_condition.size
        print('use pose condition')
    else:
        print('skip pose condition')

    if width_sketch and width_pose:
        if not (width_sketch == width_pose and height_sketch == height_pose):
            raise ValueError('conditions should be same size')
    width = max(width_pose, width_sketch) or (args.width or 512)
    height = max(height_pose, height_sketch) or (args.height or 512)
    if pipe.device.type == 'cuda':
        torch.cuda.synchronize(pipe.device)
    report['load_s'] = time.perf_counter() - t0

    input_prompt = [prepare_text(args.prompt, args.prompt_rewrite, height,
                                 width)]
    t0 = time.perf_counter()
    images = pipe(
        prompt=input_prompt,
        negative_prompt=[args.negative_prompt],
        keypose_adapter_input=(
            [keypose_condition] if keypose_condition else None),
        keypose_adaptor_weight=args.keypose_adaptor_weight,
        region_keypose_adaptor_weight=args.region_keypose_adaptor_weight,
        sketch_adapter_input=(
            [sketch_condition] if sketch_condition else None),
        sketch_adaptor_weight=args.sketch_adaptor_weight,
        region_sketch_adaptor_weight=args.region_sketch_adaptor_weight,
        height=height, width=width,
        num_inference_steps=args.num_inference_steps,
        num_images_per_prompt=args.num_images_per_prompt,
        seed=args.seed, output_type='pil')
    report['sample_s'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    configs = [
        f'pretrained_model: {args.pretrained_model}\n',
        f'context_prompt: {args.prompt}\n',
        f'neg_context_prompt: {args.negative_prompt}\n',
        f'sketch_condition: {args.sketch_condition}\n',
        f'sketch_adaptor_weight: {args.sketch_adaptor_weight}\n',
        f'region_sketch_adaptor_weight: {args.region_sketch_adaptor_weight}\n',
        f'keypose_condition: {args.keypose_condition}\n',
        f'keypose_adaptor_weight: {args.keypose_adaptor_weight}\n',
        f'region_keypose_adaptor_weight: '
        f'{args.region_keypose_adaptor_weight}\n',
        f'random seed: {args.seed}\n',
        f'prompt_rewrite: {args.prompt_rewrite}\n',
    ]
    hash_code = hashlib.sha256(''.join(configs).encode()).hexdigest()[:8]
    save_prompt = input_prompt[0][0].replace(' ', '_')
    save_dir = os.path.join(args.save_dir or 'results/regional',
                            f'seed_{args.seed}')
    os.makedirs(save_dir, exist_ok=True)
    report['files'] = []
    for i, image in enumerate(images):
        idx = f'---{i}' if len(images) > 1 else ''
        save_name = f'{save_prompt}---{args.suffix}---{hash_code}{idx}.png'
        image.save(os.path.join(save_dir, save_name))
        with open(os.path.join(save_dir, save_name.replace('.png', '.txt')),
                  'w') as fw:
            fw.writelines(configs)
        report['files'].append(os.path.join(save_dir, save_name))
        print(f'saved {os.path.join(save_dir, save_name)}')
    report['save_s'] = time.perf_counter() - t0
    return report['files']


if __name__ == '__main__':
    main()
