"""The dilated 3x3 convolution of the stride-8 trunk, plain PyTorch.

K2's plain twins (kernels/conv_cuda.py holds the CUDA kernels): a stride-1
3x3 conv with dilation d and SAME padding |d|, NHWC x HWIO -> NHWC, computed
as the arithmetic of wseg_tpu/kernels/conv_pallas.py:41-50 spells it: nine
shifted `x_pad[...] @ k[dy, dx]` products summed into one accumulator,
written independently of cuDNN; and its weight gradient, nine products of
the shifted x with the output's gradient. Tap (dy, dx) reads x at ((dy-1)d,
(dx-1)d): a negative d is the conv with the kernel rotated 180 degrees, which
is how the input gradient is computed (the conv of the output's gradient at
dilation -d with the kernel's channels swapped).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _taps(x: torch.Tensor, dilation: int):
    """(dy, dx, x at tap (dy, dx)) of x (B, H, W, C), zero outside the image."""
    _, h, w, _ = x.shape
    d = int(dilation)
    a = abs(d)
    xp = F.pad(x, (0, 0, a, a, a, a))  # (B, H + 2|d|, W + 2|d|, C)
    for dy in range(3):
        for dx in range(3):
            y0, x0 = a + (dy - 1) * d, a + (dx - 1) * d
            yield dy, dx, xp[:, y0: y0 + h, x0: x0 + w, :]


def conv3x3_dilated_plain(x: torch.Tensor, k: torch.Tensor, dilation: int = 4) -> torch.Tensor:
    """x (B, H, W, CI), k (3, 3, CI, CO). Returns (B, H, W, CO) in x.dtype,
    accumulated in float32 (float64 for float64 x)."""
    b, h, w, _ = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((b, h, w, k.shape[-1]), dtype=acc_dtype, device=x.device)
    for dy, dx, tap in _taps(x, dilation):
        acc += tap.to(acc_dtype) @ k[dy, dx].to(acc_dtype)
    return acc.to(x.dtype)


def conv3x3_dilated_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                                dilation: int = 4) -> torch.Tensor:
    """The gradient of conv3x3_dilated_plain(x, k, dilation) with respect to
    k, from x (B, H, W, CI) and the output's gradient g (B, H, W, CO), in the
    torch layout (CO, CI, 3, 3): dW[co, ci, dy, dx] = sum over pixels p of
    x[p + ((dy-1)d, (dx-1)d), ci] g[p, co]. In x.dtype, accumulated in
    float32 (float64 for float64 x)."""
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    gt = g.reshape(-1, g.shape[-1]).t().to(acc_dtype)  # (CO, pixels)
    out = torch.empty((g.shape[-1], x.shape[-1], 3, 3), dtype=acc_dtype, device=x.device)
    for dy, dx, tap in _taps(x, dilation):
        out[:, :, dy, dx] = gt @ tap.reshape(-1, x.shape[-1]).to(acc_dtype)
    return out.to(x.dtype)
