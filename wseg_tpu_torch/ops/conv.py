"""The dilated 3x3 convolution of the stride-8 trunk, plain PyTorch.

K2's plain twin (kernels/conv_cuda.py holds the CUDA kernel): a stride-1
3x3 conv with dilation d and SAME padding d, NHWC x HWIO -> NHWC, computed
as the arithmetic of wseg_tpu/kernels/conv_pallas.py:41-50 spells it: nine
shifted `x_pad[...] @ k[dy, dx]` products summed into one float32
accumulator, written independently of cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_dilated_plain(x: torch.Tensor, k: torch.Tensor, dilation: int = 4) -> torch.Tensor:
    """x (B, H, W, CI), k (3, 3, CI, CO). Returns (B, H, W, CO) in x.dtype,
    accumulated in float32."""
    b, h, w, _ = x.shape
    d = int(dilation)
    xp = F.pad(x, (0, 0, d, d, d, d))  # (B, H + 2d, W + 2d, CI)
    acc = torch.zeros((b, h, w, k.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy * d: dy * d + h, dx * d: dx * d + w, :]
            acc += tap.float() @ k[dy, dx].float()
    return acc.to(x.dtype)
