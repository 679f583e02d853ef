"""CAM normalization / fusion ops, NCHW (counterpart of wseg_tpu/ops/cam.py).

* `max_norm` — tool/visualization.py:54-83 of the reference
* `max_onehot` — contrast_train.py:28-32
* `cam_bg_complete` — network/resnet38_contrast.py:41-48 (the PCM seed)
* `fuse_msf_cams` — contrast_infer.py:75-80 (multi-scale + flip fusion)
"""

from __future__ import annotations

import torch


def max_norm(p: torch.Tensor, e: float = 1e-5) -> torch.Tensor:
    """Per-(sample, class) min/max normalization of (N, C, H, W): relu, then
    `relu(p - min - e) / (max - min + e)` over the spatial dims."""
    p = torch.relu(p)
    max_v = p.amax(dim=(2, 3), keepdim=True)
    min_v = p.amin(dim=(2, 3), keepdim=True)
    return torch.relu(p - min_v - e) / (max_v - min_v + e)


def max_onehot(x: torch.Tensor) -> torch.Tensor:
    """Zero the foreground channels that are not the per-pixel fg max.
    `x`: (N, C, H, W) with channel 0 = background."""
    fg = x[:, 1:]
    fg_max = fg.amax(dim=1, keepdim=True)
    fg = torch.where(fg < fg_max, torch.zeros_like(fg), fg)
    return torch.cat([x[:, :1], fg], dim=1)


def cam_bg_complete(cam_d: torch.Tensor, e: float = 1e-5,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized, background-completed CAM that seeds PCM.

    `cam_d`: raw (N, 21, H, W) CAM logits. Per class: relu, divide by the
    spatial max (+e); background becomes `1 - max(fg)`; fg keeps only the
    per-pixel argmax. `mask` (N, 1, H, W) restricts the spatial max to each
    sample's valid region and zeroes the output's pad halo."""
    cam_d = torch.relu(cam_d)
    if mask is not None:
        cam_d = cam_d * mask
    cam_max = cam_d.amax(dim=(2, 3), keepdim=True) + e
    cam_norm = torch.relu(cam_d - e) / cam_max
    fg = cam_norm[:, 1:]
    fg_max = fg.amax(dim=1, keepdim=True)
    bg = 1.0 - fg_max
    fg = torch.where(fg < fg_max, torch.zeros_like(fg), fg)
    out = torch.cat([bg, fg], dim=1)
    if mask is not None:
        out = out * mask
    return out


def fuse_msf_cams(cam_sum: torch.Tensor, e: float = 1e-5) -> torch.Tensor:
    """Min/max-normalize a CAM summed over the multi-scale + flip views.

    `cam_sum`: (..., C, H, W), already flipped back and summed; min and max
    are per channel over the last two dims. Returns the same shape in [0, 1].
    """
    cam_sum = torch.clamp(cam_sum, min=0.0)
    cam_max = cam_sum.amax(dim=(-2, -1), keepdim=True)
    cam_min = cam_sum.amin(dim=(-2, -1), keepdim=True)
    cam_sum = torch.where(cam_sum < cam_min + e, torch.zeros_like(cam_sum), cam_sum)
    return (cam_sum - cam_min - e) / (cam_max - cam_min + e)
