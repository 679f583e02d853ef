"""Visualization helpers for the stage-3 training log (the parts of
wseg_tpu/utils/visualization.py that seg_train uses): the VOC label colormap
and the inverse of the input normalisation. numpy only."""

from __future__ import annotations

import numpy as np


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
