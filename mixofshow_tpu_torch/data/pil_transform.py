"""Paired image+mask augmentation pipeline (host-side, PIL/numpy/cv2).

Port of mixofshow_tpu/data/pil_transform.py, jax-free, with the same Python
`random` calls in the same order, so a seeded run gives identical outputs in
both packages. Behavioral equivalent of the reference transform registry
(mixofshow/data/pil_transform.py) without torchvision: transforms operate
on PIL images and numpy arrays and emit float32 HWC arrays.

Registry-driven construction from YAML (`instance_transform` lists of
{type: Name, ...kwargs}), arity-dispatched composition (single-arg
transforms touch the image only; paired transforms also carry
mask/img_mask/prompts through), matching the reference's PairCompose
(pil_transform.py:102-114).
"""
from __future__ import annotations

import inspect
import random
from copy import deepcopy
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from mixofshow_tpu_torch.utils.registry import TRANSFORM_REGISTRY

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def build_transform(opt: dict):
    opt = deepcopy(dict(opt))
    ttype = opt.pop('type')
    return TRANSFORM_REGISTRY.get(ttype)(**opt)


# ------------------------------------------------------------ PIL helpers
def _resize_short(img: Image.Image, size: int,
                  max_size: Optional[int] = None,
                  nearest: bool = False) -> Image.Image:
    """torchvision F.resize semantics: short edge → size (aspect kept);
    with max_size, cap the long edge and rescale accordingly."""
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    new_short = size
    new_long = int(round(size * long / short))
    if max_size is not None and new_long > max_size:
        new_long = max_size
        new_short = int(round(max_size * short / long))
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return img.resize((nw, nh), resample)


def _resize_wh(img: Image.Image, height: int, width: int,
               nearest: bool = False) -> Image.Image:
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return img.resize((width, height), resample)


def _crop(img: Image.Image, top: int, left: int, height: int,
          width: int) -> Image.Image:
    return img.crop((left, top, left + width, top + height))


def _resize_mask_small(arr: np.ndarray, size: int) -> np.ndarray:
    """Downsample a (H, W) float mask to (size/8, size/8) nearest."""
    target = (size // 8, size // 8)
    if _HAS_CV2:
        return cv2.resize(arr, target, interpolation=cv2.INTER_NEAREST)
    img = Image.fromarray((arr * 255).astype(np.uint8))
    return np.asarray(img.resize(target, Image.NEAREST),
                      np.float32) / 255.0


# --------------------------------------------------------- basic transforms
@TRANSFORM_REGISTRY.register()
class Resize:
    def __init__(self, size):
        self.size = size

    def forward(self, img):
        if isinstance(self.size, int):
            return _resize_short(img, self.size)
        return _resize_wh(img, self.size[0], self.size[1])


@TRANSFORM_REGISTRY.register()
class BILINEARResize(Resize):
    pass


@TRANSFORM_REGISTRY.register()
class CenterCrop:
    def __init__(self, size):
        self.h, self.w = (size, size) if isinstance(size, int) else size

    def forward(self, img):
        w, h = img.size
        top = max(0, (h - self.h) // 2)
        left = max(0, (w - self.w) // 2)
        return _crop(img, top, left, self.h, self.w)


@TRANSFORM_REGISTRY.register()
class RandomCrop:
    def __init__(self, size):
        self.h, self.w = (size, size) if isinstance(size, int) else size

    def forward(self, img):
        w, h = img.size
        y = random.randint(0, h - self.h)
        x = random.randint(0, w - self.w)
        return _crop(img, y, x, self.h, self.w)


@TRANSFORM_REGISTRY.register()
class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def forward(self, img):
        if random.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


@TRANSFORM_REGISTRY.register()
class ToTensor:
    """PIL → float32 HWC in [0,1] (channels-last, the batch layout)."""

    def forward(self, img):
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr


@TRANSFORM_REGISTRY.register()
class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def forward(self, img):
        return (img - self.mean) / self.std


# --------------------------------------------------------- paired transforms
@TRANSFORM_REGISTRY.register()
class PairResize:
    def __init__(self, size):
        self.size = size

    def forward(self, img, **kwargs):
        img = _resize_short(img, self.size)
        if 'mask' in kwargs:
            kwargs['mask'] = _resize_short(kwargs['mask'], self.size)
        return img, kwargs


@TRANSFORM_REGISTRY.register()
class PairRandomCrop:
    def __init__(self, size):
        self.h, self.w = (size, size) if isinstance(size, int) else size

    def forward(self, img, **kwargs):
        w, h = img.size
        mw, mh = kwargs['mask'].size
        assert h >= self.h and h == mh and w >= self.w and w == mw
        y = random.randint(0, h - self.h)
        x = random.randint(0, w - self.w)
        img = _crop(img, y, x, self.h, self.w)
        kwargs['mask'] = _crop(kwargs['mask'], y, x, self.h, self.w)
        return img, kwargs


@TRANSFORM_REGISTRY.register()
class PairRandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def forward(self, img, **kwargs):
        if random.random() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if 'mask' in kwargs:
                kwargs['mask'] = kwargs['mask'].transpose(Image.FLIP_LEFT_RIGHT)
        return img, kwargs


def _paste_on_canvas(img: Image.Image, mask_arr: Optional[np.ndarray],
                     size: int):
    """Random-place the (≤size) image on a black size×size canvas; emit the
    placement mask. Shared tail of HumanResizeCropFinalV3 /
    ResizeFillMaskNew (reference pil_transform.py:161-189,230-258)."""
    new_w, new_h = img.size
    arr = np.asarray(img)
    start_y = random.randint(0, size - new_h)
    start_x = random.randint(0, size - new_w)

    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[start_y:start_y + new_h, start_x:start_x + new_w] = arr
    img_mask = np.zeros((size, size), np.float32)
    img_mask[start_y:start_y + new_h, start_x:start_x + new_w] = 1.0

    out_mask = None
    if mask_arr is not None:
        out_mask = np.zeros((size, size), np.float32)
        out_mask[start_y:start_y + new_h, start_x:start_x + new_w] = mask_arr
    return Image.fromarray(canvas), out_mask, img_mask


@TRANSFORM_REGISTRY.register()
class HumanResizeCropFinalV3:
    """Short-edge resize → optional random crop → fit-inside resize →
    random placement on canvas; emits latent-res `mask` and `img_mask`
    (reference pil_transform.py:126-189)."""

    def __init__(self, size, crop_p=0.5):
        self.size = size
        self.crop_p = crop_p

    def forward(self, img, **kwargs):
        img = _resize_short(img, self.size)
        if 'mask' in kwargs:
            kwargs['mask'] = _resize_short(kwargs['mask'], self.size)

        w, h = img.size
        if random.random() < self.crop_p:
            if h > w:
                # top-anchored crop to a (w+rand, w) tall strip
                crop_pos = random.randint(0, h - w)
                img = _crop(img, 0, 0, w + crop_pos, w)
                if 'mask' in kwargs:
                    kwargs['mask'] = _crop(kwargs['mask'], 0, 0,
                                           w + crop_pos, w)
            else:
                if 'mask' in kwargs:
                    img, kwargs = PairRandomCrop(self.size).forward(img, **kwargs)
                else:
                    img = RandomCrop(self.size).forward(img)

        img = _resize_short(img, self.size - 1, max_size=self.size)
        if 'mask' in kwargs:
            kwargs['mask'] = _resize_short(kwargs['mask'], self.size - 1,
                                           max_size=self.size)

        mask_arr = None
        if 'mask' in kwargs:
            mask_arr = np.asarray(kwargs['mask'], np.float32) / 255.0
        img, out_mask, img_mask = _paste_on_canvas(img, mask_arr, self.size)
        if out_mask is not None:
            kwargs['mask'] = _resize_mask_small(out_mask, self.size)
        kwargs['img_mask'] = _resize_mask_small(img_mask, self.size)
        return img, kwargs


@TRANSFORM_REGISTRY.register()
class ResizeFillMaskNew:
    """Resize → optional crop → random aspect-ratio scale → random placement
    (reference pil_transform.py:193-260)."""

    def __init__(self, size, crop_p, scale_ratio):
        self.size = size
        self.crop_p = crop_p
        self.scale_ratio = tuple(scale_ratio)

    def forward(self, img, **kwargs):
        img = _resize_short(img, self.size)
        if 'mask' in kwargs:
            kwargs['mask'] = _resize_short(kwargs['mask'], self.size)

        if random.random() < self.crop_p:
            if 'mask' in kwargs:
                img, kwargs = PairRandomCrop(self.size).forward(img, **kwargs)
            else:
                img = RandomCrop(self.size).forward(img)
        else:
            img = _resize_short(img, self.size - 1, max_size=self.size)
            if 'mask' in kwargs:
                kwargs['mask'] = _resize_short(kwargs['mask'], self.size - 1,
                                               max_size=self.size)

        w, h = img.size
        ratio = random.uniform(*self.scale_ratio)
        img = _resize_wh(img, int(h * ratio), int(w * ratio))
        if 'mask' in kwargs:
            kwargs['mask'] = _resize_wh(kwargs['mask'], int(h * ratio),
                                        int(w * ratio), nearest=True)

        mask_arr = None
        if 'mask' in kwargs:
            mask_arr = np.asarray(kwargs['mask'], np.float32) / 255.0
        img, out_mask, img_mask = _paste_on_canvas(img, mask_arr, self.size)
        if out_mask is not None:
            kwargs['mask'] = _resize_mask_small(out_mask, self.size)
        kwargs['img_mask'] = _resize_mask_small(img_mask, self.size)
        return img, kwargs


# ----------------------------------------------------------- text transforms
@TRANSFORM_REGISTRY.register()
class ShuffleCaption:
    """Shuffle comma-separated caption chunks, keeping the first
    `keep_token_num` fixed (reference pil_transform.py:264-281)."""

    def __init__(self, keep_token_num):
        self.keep_token_num = keep_token_num

    def forward(self, img, **kwargs):
        parts = [t.strip() for t in kwargs['prompts'].strip().split(',')]
        fixed, flex = parts[:self.keep_token_num], parts[self.keep_token_num:]
        random.shuffle(flex)
        kwargs['prompts'] = ', '.join(fixed + flex)
        return img, kwargs


# Template banks: the standard textual-inversion caption templates (public,
# from the Textual Inversion paper's released code) plus a human-photo bank;
# same three enhance_type categories as the reference (pil_transform.py:285).
_STYLE_TEMPLATES = [
    'a painting in the style of {}', 'a rendering in the style of {}',
    'a cropped painting in the style of {}', 'the painting in the style of {}',
    'a clean painting in the style of {}', 'a dirty painting in the style of {}',
    'a dark painting in the style of {}', 'a picture in the style of {}',
    'a cool painting in the style of {}',
    'a close-up painting in the style of {}',
    'a bright painting in the style of {}', 'a good painting in the style of {}',
    'a rendition in the style of {}', 'a nice painting in the style of {}',
    'a small painting in the style of {}', 'a weird painting in the style of {}',
    'a large painting in the style of {}',
]

_OBJECT_TEMPLATES = [
    'a photo of a {}', 'a rendering of a {}', 'a cropped photo of the {}',
    'the photo of a {}', 'a photo of a clean {}', 'a photo of a dirty {}',
    'a dark photo of the {}', 'a photo of my {}', 'a photo of the cool {}',
    'a close-up photo of a {}', 'a bright photo of the {}',
    'a cropped photo of a {}', 'a photo of the {}', 'a good photo of the {}',
    'a photo of one {}', 'a close-up photo of the {}', 'a rendition of the {}',
    'a photo of the clean {}', 'a rendition of a {}', 'a photo of a nice {}',
    'a good photo of a {}', 'a photo of the nice {}', 'a photo of the small {}',
    'a photo of the weird {}', 'a photo of the large {}',
    'a photo of a cool {}', 'a photo of a small {}',
]

_HUMAN_TEMPLATES = [
    'a photo of a {}', 'a photo of one {}', 'a photo of the {}',
    'the photo of a {}', 'a rendering of a {}', 'a rendition of the {}',
    'a rendition of a {}', 'a cropped photo of the {}',
    'a cropped photo of a {}', 'a bad photo of the {}', 'a bad photo of a {}',
    'a photo of a weird {}', 'a weird photo of a {}',
    'a bright photo of the {}', 'a good photo of the {}',
    'a photo of a nice {}', 'a good photo of a {}', 'a photo of a cool {}',
]


@TRANSFORM_REGISTRY.register()
class EnhanceText:
    """Wrap the caption in a random category template
    (reference pil_transform.py:285-364)."""

    def __init__(self, enhance_type='object'):
        banks = {'object': _OBJECT_TEMPLATES, 'style': _STYLE_TEMPLATES,
                 'human': _HUMAN_TEMPLATES}
        if enhance_type not in banks:
            raise NotImplementedError(enhance_type)
        self.templates = banks[enhance_type]

    def forward(self, img, **kwargs):
        kwargs['prompts'] = random.choice(self.templates).format(
            kwargs['prompts'].strip())
        return img, kwargs


# ---------------------------------------------------------------- compose
class PairCompose:
    """Arity-dispatched composition: single-parameter transforms see only the
    image; paired transforms thread (img, **kwargs)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, **kwargs):
        for t in self.transforms:
            n_params = len(inspect.signature(t.forward).parameters)
            if n_params == 1:
                img = t.forward(img)
            else:
                img, kwargs = t.forward(img, **kwargs)
        return img, kwargs
