"""Host-side image transforms (counterpart of wseg_tpu/data/transforms.py;
reference tool/imutils.py and the torchvision parts of contrast_train.py:64-75).

Images and views are HWC numpy arrays or PIL images, as the JAX package
makes them; infer/cam.py and the training loader turn them into NCHW
tensors. PIL is imported where it is used.

The random transforms take an optional `rng` (a `random.Random`): with one,
a sample's augmentation is a function of that rng alone, whatever the thread
schedule (the deterministic pipeline behind resumed training runs); without,
they draw from the global `random` stream. Given the same rng they draw the
same numbers as the JAX package's transforms.
"""

from __future__ import annotations

import random

import numpy as np

from wseg_tpu_torch.models.resnet38 import IMAGENET_MEAN, IMAGENET_STD


class Normalize:
    """uint8 HWC -> normalized float32 (network/resnet38d.py:104-118)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img) -> np.ndarray:
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return (arr - self.mean) / self.std


def msf_views(img, scales, unit: int = 1) -> list[np.ndarray]:
    """Multi-scale + flip views of a PIL image (voc12/data.py:100-121): for
    each scale, PIL-bicubic resize of the (unit-rounded) image, then
    [view, flipped]. Returns raw uint8 HWC arrays (normalize separately)."""
    import PIL.Image

    rounded = (
        int(round(img.size[0] / unit) * unit),
        int(round(img.size[1] / unit) * unit),
    )
    out = []
    for s in scales:
        target = (round(rounded[0] * s), round(rounded[1] * s))
        s_img = np.asarray(img.resize(target, resample=PIL.Image.BICUBIC))
        out.append(s_img)
        out.append(np.flip(s_img, axis=1).copy())
    return out


class RandomResizeLong:
    """Resize (PIL bicubic) so the long side is uniform in [min_long,
    max_long] (tool/imutils.py:6-26)."""

    def __init__(self, min_long: int, max_long: int):
        self.min_long = min_long
        self.max_long = max_long

    def __call__(self, img, rng=None):
        import PIL.Image

        target_long = (rng or random).randint(self.min_long, self.max_long)
        w, h = img.size
        if w < h:
            shape = (int(round(w * target_long / h)), target_long)
        else:
            shape = (target_long, int(round(h * target_long / w)))
        return img.resize(shape, resample=PIL.Image.BICUBIC)


class RandomHorizontalFlip:
    """Flip a PIL image left-right with probability 1/2."""

    def __call__(self, img, rng=None):
        import PIL.Image

        if bool((rng or random).getrandbits(1)):
            return img.transpose(PIL.Image.FLIP_LEFT_RIGHT)
        return img


class ColorJitter:
    """torchvision-equivalent ColorJitter: brightness, contrast, saturation
    and hue with uniform factors, applied in a random order."""

    def __init__(self, brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _adjust_hue(img, factor: float):
        import PIL.Image

        if factor == 0:
            return img
        h, s, v = img.convert("HSV").split()
        h_np = (np.array(h, dtype=np.uint8).astype(np.int16) + int(factor * 255)) % 256
        h = PIL.Image.fromarray(h_np.astype(np.uint8), "L")
        return PIL.Image.merge("HSV", (h, s, v)).convert("RGB")

    def __call__(self, img, rng=None):
        import PIL.ImageEnhance

        r = rng or random
        ops = []
        if self.brightness > 0:
            f = r.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: PIL.ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = r.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: PIL.ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = r.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: PIL.ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            f = r.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: self._adjust_hue(im, f))
        r.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class RandomCrop:
    """Random crop of an HWC array, zero-padded to `cropsize` where the image
    is smaller (tool/imutils.py:29-67)."""

    def __init__(self, cropsize: int):
        self.cropsize = cropsize

    def get_box(self, h: int, w: int, rng=None):
        r = rng or random
        ch, cw = min(self.cropsize, h), min(self.cropsize, w)
        w_space, h_space = w - self.cropsize, h - self.cropsize
        if w_space > 0:
            cont_left, img_left = 0, r.randrange(w_space + 1)
        else:
            cont_left, img_left = r.randrange(-w_space + 1), 0
        if h_space > 0:
            cont_top, img_top = 0, r.randrange(h_space + 1)
        else:
            cont_top, img_top = r.randrange(-h_space + 1), 0
        return cont_top, cont_left, img_top, img_left, ch, cw

    def apply(self, arr: np.ndarray, box) -> np.ndarray:
        cont_top, cont_left, img_top, img_left, ch, cw = box
        out = np.zeros((self.cropsize, self.cropsize, arr.shape[-1]), np.float32)
        out[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
            arr[img_top:img_top + ch, img_left:img_left + cw]
        return out

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        return self.apply(arr, self.get_box(*arr.shape[:2], rng))


class AvgPool2d:
    """Non-overlapping k x k mean of an HWC array, zero-padded up to
    multiples of k first (tool/imutils.py:130-138, skimage's block_reduce)."""

    def __init__(self, ksize: int):
        self.ksize = ksize

    def __call__(self, img: np.ndarray) -> np.ndarray:
        k = self.ksize
        h, w = img.shape[:2]
        if h % k or w % k:
            img = np.pad(img, ((0, -h % k), (0, -w % k), (0, 0)), mode="constant")
            h, w = img.shape[:2]
        return img.reshape(h // k, k, w // k, k, -1).mean(axis=(1, 3))
