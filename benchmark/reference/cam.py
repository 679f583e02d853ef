"""Multi-scale x flip CAM seeds of one image, plain PyTorch (contrast_infer.py
of arXiv:2110.07110's code).

From the decoded uint8 image: per scale, a PIL bicubic resize to
(round(W s), round(H s)), the view and its mirror normalised with the
ImageNet mean and std, the net at the view's exact size, the refined CAM's
foreground upsampled to the view (align_corners=True) and then to the image
(align_corners=False), the mirror flipped back; the views summed, masked by
the image's labels, and min/max normalised per class.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import contrast_net

MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def views(img: np.ndarray, scales) -> list[np.ndarray]:
    """[(h_s, w_s, 3) float32 normalised view per scale] of an (H, W, 3) uint8
    image."""
    from PIL import Image

    pil = Image.fromarray(img)
    out = []
    for s in scales:
        target = (round(img.shape[1] * s), round(img.shape[0] * s))
        v = np.asarray(pil.resize(target, resample=Image.BICUBIC), np.float32) / 255.0
        out.append((v - MEAN) / STD)
    return out


def fuse(total: torch.Tensor, e: float = 1e-5) -> torch.Tensor:
    """Min/max normalisation of the summed CAM (C, H, W), per class."""
    total = torch.clamp(total, min=0.0)
    hi = total.amax(dim=(-2, -1), keepdim=True)
    lo = total.amin(dim=(-2, -1), keepdim=True)
    total = torch.where(total < lo + e, torch.zeros_like(total), total)
    return (total - lo - e) / (hi - lo + e)


@torch.no_grad()
def msf_cam(params: dict, img: np.ndarray, label: np.ndarray, scales,
            dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The fused (20, H, W) float32 CAM of one image. `params` is on the device
    the work runs on, in `dtype`; the upsampling, the sum and the fusion run in
    float32 whatever `dtype` is, PCM too."""
    dev = next(iter(params.values())).device
    h, w = img.shape[:2]
    total = torch.zeros((20, h, w), dtype=torch.float32, device=dev)
    for v in views(img, scales):
        pair = torch.from_numpy(np.stack([v, v[:, ::-1]])).permute(0, 3, 1, 2)
        pair = pair.to(dev, dtype)
        _, cam_rv_down = contrast_net.forward(params, pair, raw_cam=True,
                                              pcm_dtype=torch.float32)
        cam = cam_rv_down[:, 1:].float()
        cam = contrast_net.up(cam, v.shape[:2], align_corners=True)
        cam = contrast_net.up(cam, (h, w), align_corners=False)
        total += cam[0] + cam[1].flip(-1)
    mask = torch.as_tensor(np.asarray(label, np.float32), device=dev)[:, None, None]
    return fuse(total * mask).cpu().numpy()
