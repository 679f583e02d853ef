"""Pixel Correlation Module (PCM): the SEAM CAM refinement, plain PyTorch.

Given the f9 feature map f and a CAM: L2-normalize f per pixel, build the
pixel-pair affinity `aff = relu(fn fn^T)`, column-normalize it, and propagate
the CAM through it (network/resnet38_contrast.py:63-75 of the reference).

This is the eager, maskable, differentiable formula. It is what training uses
and the plain version that the CUDA kernel (kernels/pcm_cuda.py) is held
against; it writes the hw x hw affinity out, so inference on the GPU goes
through the kernel instead.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.ops.resize import resize_bilinear


def pcm_flat(cam: torch.Tensor, f: torch.Tensor, eps: float = 1e-5,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """cam (N, HW, C) at f's resolution; f (N, HW, Cf) raw features; mask
    optional (N, HW) or (N, HW, 1) valid-pixel mask. Returns (N, HW, C)."""
    fv = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + eps)
    if mask is not None:
        fv = fv * mask.reshape(f.shape[0], f.shape[1], 1).to(fv.dtype)
    # aff[i, j] = relu(<f_i, f_j>), column-normalized over i
    aff = torch.relu(torch.bmm(fv, fv.transpose(1, 2)))
    aff = aff / (aff.sum(dim=1, keepdim=True) + eps)
    return torch.bmm(aff.transpose(1, 2), cam.to(aff.dtype)).to(cam.dtype)


def pcm(cam: torch.Tensor, f: torch.Tensor, eps: float = 1e-5,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Propagate `cam` through the pixel affinity of `f`.

    cam: (N, C, Hc, Wc), resized to f's spatial dims (align_corners=True)
    f:   (N, Cf, H, W), output of the f9 1x1 conv
    mask: optional (N, 1, H, W) valid-region mask (bucketed inference): pad
    pixels leave the affinity (rows and columns), so valid outputs equal the
    exact-shape PCM.
    Returns (N, C, H, W).
    """
    n, cf, h, w = f.shape
    cam = resize_bilinear(cam, (h, w), align_corners=True)
    c = cam.shape[1]
    out = pcm_flat(
        cam.permute(0, 2, 3, 1).reshape(n, h * w, c),
        f.permute(0, 2, 3, 1).reshape(n, h * w, cf),
        eps, None if mask is None else mask.reshape(n, h * w),
    )
    return out.reshape(n, h, w, c).permute(0, 3, 1, 2)
