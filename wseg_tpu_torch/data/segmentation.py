"""A simple (image, mask) segmentation dataset (counterpart of
wseg_tpu/data/segmentation.py; reference tool/torchutils.py:84-134
`SegmentationDataset`, which the reference's pipeline never uses).

The reference's `mask = img.resize(...)` typo (:114, which rescales the
image as the mask) is fixed, as in the JAX package: the mask resizes with
NEAREST to the image's size and is subsampled 8x to the backbone's stride.
Items are (name, HWC float32 image, (H/8, W/8) int32 mask). `rng` (a
`random.Random`) draws the rescale, crop and flip; without one, the global
`random` stream does, as in the JAX package.
"""

from __future__ import annotations

import os
import random

import numpy as np

from wseg_tpu_torch.data import transforms as T
from wseg_tpu_torch.data.voc12 import load_img_name_list


class SegmentationDataset:
    def __init__(self, img_name_list_path: str, img_dir: str, label_dir: str,
                 rescale=None, cropsize: int | None = None, flip: bool = False, rng=None):
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.img_dir = img_dir
        self.label_dir = label_dir
        self.rescale = rescale
        self.cropsize = cropsize
        self.flip = flip
        self.normalize = T.Normalize()
        self.rng = rng

    def __len__(self):
        return len(self.img_name_list)

    def __getitem__(self, idx: int):
        import PIL.Image

        r = self.rng or random
        name = self.img_name_list[idx]
        img = PIL.Image.open(os.path.join(self.img_dir, name + ".jpg")).convert("RGB")
        mask = PIL.Image.open(os.path.join(self.label_dir, name + ".png"))

        if self.rescale is not None:
            s = self.rescale[0] + r.random() * (self.rescale[1] - self.rescale[0])
            adj = (round(img.size[0] * s / 8) * 8, round(img.size[1] * s / 8) * 8)
            img = img.resize(adj, resample=PIL.Image.BICUBIC)
            mask = mask.resize(adj, resample=PIL.Image.NEAREST)

        arr = self.normalize(img)
        mask_np = np.asarray(mask, np.float32)

        if self.cropsize is not None:
            crop = T.RandomCrop(self.cropsize)
            box = crop.get_box(*arr.shape[:2], rng=self.rng)
            arr = crop.apply(arr, box)
            ct, cl, it_, il, ch, cw = box
            m = np.full((self.cropsize, self.cropsize), 255.0, np.float32)
            m[ct:ct + ch, cl:cl + cw] = mask_np[it_:it_ + ch, il:il + cw]
            mask_np = m

        mask_np = mask_np[::8, ::8]  # the stride-8 nearest subsample

        if self.flip and bool(r.getrandbits(1)):
            arr = np.fliplr(arr).copy()
            mask_np = np.fliplr(mask_np).copy()

        return name, arr, mask_np.astype(np.int32)
