"""Instance-image dataset for ED-LoRA tuning.

Port of mixofshow_tpu/data/lora_dataset.py, jax-free, the same Python
`random` calls in the same order (reference `LoraDataset`,
mixofshow/data/lora_dataset.py:13-102): concept JSON → (image, caption,
mask) triples with <TOK> replacement, per-image caption files, enlarge-ratio
virtual length, and the paired transform pipeline. Pure host-side
numpy/PIL; emits float32 HWC arrays ready for batching.
"""
from __future__ import annotations

import json
import os
import random
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from mixofshow_tpu_torch.data.pil_transform import (PairCompose,
                                                    build_transform)


def _clean_text(text: str, replace_mapping: Dict[str, str]) -> str:
    for k, v in replace_mapping.items():
        text = text.replace(k, v)
    return re.sub(' +', ' ', text.strip())


class LoraDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        replace_mapping = opt.get('replace_mapping', {})
        use_caption = opt.get('use_caption', False)
        use_mask = opt.get('use_mask', False)

        with open(opt['concept_list']) as f:
            concept_list = json.load(f)

        items: List[Tuple[str, str, Optional[str]]] = []
        for concept in concept_list:
            prompt = _clean_text(concept['instance_prompt'], replace_mapping)
            caption_dir = concept.get('caption_dir')
            mask_dir = concept.get('mask_dir')
            for p in sorted(Path(concept['instance_data_dir']).iterdir()):
                if not p.is_file() or p.name == '.DS_Store':
                    continue
                base = p.stem
                item_prompt = prompt
                if use_caption and caption_dir:
                    cpath = os.path.join(caption_dir, f'{base}.txt')
                    if os.path.exists(cpath):
                        with open(cpath) as fr:
                            item_prompt = _clean_text(fr.readlines()[0],
                                                      replace_mapping)
                mask_path = (os.path.join(mask_dir, f'{base}.png')
                             if use_mask and mask_dir else None)
                items.append((str(p), item_prompt, mask_path))

        random.shuffle(items)
        self.items = items
        self.num_instance_images = len(items)
        self.transform = PairCompose([
            build_transform(t) for t in opt['instance_transform']])

    def __len__(self) -> int:
        return self.num_instance_images * self.opt.get(
            'dataset_enlarge_ratio', 1)

    def __getitem__(self, index: int) -> Dict:
        path, prompt, mask_path = self.items[index % self.num_instance_images]
        img = Image.open(path).convert('RGB')
        extra = {'prompts': prompt}
        if mask_path is not None:
            extra['mask'] = Image.open(mask_path).convert('L')

        img, extra = self.transform(img, **extra)

        example = {'images': np.asarray(img, np.float32),
                   'prompts': extra['prompts']}
        if 'mask' in extra:
            example['masks'] = np.asarray(extra['mask'], np.float32)[..., None]
        if 'img_mask' not in extra:
            raise NotImplementedError(
                'instance_transform must produce img_mask '
                '(use HumanResizeCropFinalV3 / ResizeFillMaskNew)')
        example['img_masks'] = np.asarray(extra['img_mask'],
                                          np.float32)[..., None]
        return example
