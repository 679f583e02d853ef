"""Visualization helpers, host-side numpy (counterpart of
wseg_tpu/utils/visualization.py; reference tool/visualization.py): the
numpy max_norm, JET-colormap CAM overlays, class-colour maps, the VOC label
colormap and the inverse of the input normalisation. cv2 is imported inside
the functions that use it."""

from __future__ import annotations

import numpy as np


def max_norm_np(p: np.ndarray, e: float = 1e-5) -> np.ndarray:
    """max_norm in the reference's 'numpy' mode (tool/visualization.py:68-82)
    over the last two axes of a (C, H, W) or (N, C, H, W) array: negatives
    to 0, values below min + e to 0, then (p - min - e) / (max + e) (the
    reference divides by max + e, not max - min + e)."""
    p = p.copy()
    axes = (1, 2) if p.ndim == 3 else (2, 3)
    p[p < 0] = 0
    max_v = np.max(p, axes, keepdims=True)
    min_v = np.min(p, axes, keepdims=True)
    p[p < min_v + e] = 0
    return (p - min_v - e) / (max_v + e)


def color_pro(pro: np.ndarray, img: np.ndarray | None = None, mode: str = "hwc") -> np.ndarray:
    """JET-colormap an (H, W) probability map in [0, 1] as uint8 RGB,
    optionally blended 50/50 with a uint8 image (HWC, or CHW with
    mode="chw", which also returns CHW)."""
    import cv2

    color = cv2.applyColorMap((pro * 255).astype(np.uint8)[..., None], cv2.COLORMAP_JET)
    color = cv2.cvtColor(color, cv2.COLOR_BGR2RGB)
    if img is not None:
        if mode == "chw":
            img = np.transpose(img, (1, 2, 0))
        color = cv2.addWeighted(img, 0.5, color, 0.5, 0)
    if mode == "chw":
        color = np.transpose(color, (2, 0, 1))
    return color


def color_cam(prob: np.ndarray, img: np.ndarray) -> np.ndarray:
    """(C, H, W) probabilities and a CHW uint8 image -> (C, 3, H, W) float
    overlays in [0, 1]."""
    return np.array([color_pro(p, img=img, mode="chw") for p in prob]) / 255.0


def color_cls(prob: np.ndarray) -> np.ndarray:
    """(C, H, W) probabilities -> (3, H, W) VOC colours of the argmax."""
    return voc_label2colormap(np.argmax(prob, axis=0)).transpose(2, 0, 1)


def voc_label2colormap(label: np.ndarray) -> np.ndarray:
    """(H, W) labels -> (H, W, 3) uint8 VOC colours; 255 (ignore) is white."""
    m = label.astype(np.uint8)
    r, c = m.shape
    cmap = np.zeros((r, c, 3), np.uint8)
    cmap[:, :, 0] = (m & 1) << 7 | (m & 8) << 3
    cmap[:, :, 1] = (m & 2) << 6 | (m & 16) << 2
    cmap[:, :, 2] = (m & 4) << 5
    cmap[m == 255] = [255, 255, 255]
    return cmap


def img_denorm(img_chw_or_hwc: np.ndarray,
               mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """Invert the imagenet normalization back to uint8 range (CHW or HWC)."""
    arr = np.asarray(img_chw_or_hwc, np.float32)
    chw = arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3
    if chw:
        arr = np.transpose(arr, (1, 2, 0))
    arr = (arr * np.asarray(std) + np.asarray(mean)) * 255.0
    arr = np.clip(arr, 0, 255)
    if chw:
        arr = np.transpose(arr, (2, 0, 1))
    return arr
