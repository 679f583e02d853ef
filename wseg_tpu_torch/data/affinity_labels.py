"""Affinity targets over radius-neighbourhood pairs, host numpy (counterpart
of wseg_tpu/data/affinity_labels.py; reference voc12/data.py:149-199).

From an (h, w) label map (255 = ignore), the (bg_pos, fg_pos, neg) float
masks over the same half-disc pairs, in the same order, as the affinity
head's output, so targets and predictions align elementwise.
"""

from __future__ import annotations

import numpy as np

from wseg_tpu_torch.models.affinity import clamped_radius
from wseg_tpu_torch.ops.pairs import search_offsets


class ExtractAffinityLabelInRadius:
    def __init__(self, cropsize: int, radius: int = 5):
        # the head's small-grid clamp: targets and predictions use one pair set
        self.radius = clamped_radius(cropsize, cropsize, radius)
        self.search_dist = search_offsets(self.radius)
        self.radius_floor = self.radius - 1
        self.crop_height = cropsize - self.radius_floor
        self.crop_width = cropsize - 2 * self.radius_floor

    def __call__(self, label: np.ndarray):
        rf = self.radius_floor
        labels_from = label[:-rf, rf:-rf].reshape(-1)
        labels_to = np.stack([
            label[dy:dy + self.crop_height, rf + dx:rf + dx + self.crop_width].reshape(-1)
            for dy, dx in self.search_dist])
        valid = np.logical_and(labels_to < 255, labels_from[None] < 255)

        pos = labels_from[None] == labels_to
        bg_pos = np.logical_and(pos, labels_from[None] == 0).astype(np.float32)
        fg_pos = np.logical_and(np.logical_and(pos, labels_from[None] != 0),
                                valid).astype(np.float32)
        neg = np.logical_and(np.logical_not(pos), valid).astype(np.float32)
        return bg_pos, fg_pos, neg
