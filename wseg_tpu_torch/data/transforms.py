"""Host-side image transforms for CAM inference (counterpart of the
`Normalize` and `msf_views` parts of wseg_tpu/data/transforms.py).

Views are HWC numpy arrays, as the JAX package makes them; infer/cam.py
turns them into NCHW tensors. PIL is imported where it is used.
"""

from __future__ import annotations

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
