"""Random-walk CAM refinement over a learned affinity matrix, NCHW
(counterpart of wseg_tpu/ops/random_walk.py; reference aff_infer.py:105-117).

Raise the dense affinity matrix to beta, column-normalise it into a
transition matrix, square it logt times (T^(2^logt)), propagate the 8x
average-pooled CAM through it and upsample bilinearly (align_corners=False).
A leading batch dim runs every image's chain as one `torch.bmm` per squaring.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.ops.resize import avg_pool2d, resize_bilinear


def random_walk_refine(cam: torch.Tensor, aff_mat: torch.Tensor, beta: int = 8,
                       logt: int = 6, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """cam: ([B,] C, H, W) CAM scores with H, W multiples of 8; aff_mat:
    ([B,] hw, hw) dense affinity, hw = H/8 * W/8. Returns the refined CAM
    ([B,] C, H, W) in float32.

    compute_dtype=torch.bfloat16 runs the squaring chain on bf16 operands
    with float32 accumulation, rounded to bf16 between squarings (the JAX
    package's preferred_element_type=float32 plus a cast back); the power,
    normalisation, propagation and upsample stay float32. On CUDA this pins
    f32 accumulation for bf16 GEMMs process-wide
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False): cuBLAS may otherwise reduce in bf16."""
    squeeze = cam.dim() == 3
    if squeeze:
        cam, aff_mat = cam[None], aff_mat[None]
    b, c, h, w = cam.shape
    dh, dw = h // 8, w // 8

    trans = aff_mat.float() ** beta
    trans = trans / trans.sum(dim=-2, keepdim=True)
    if compute_dtype is not None:
        if trans.is_cuda and compute_dtype == torch.bfloat16:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        trans = trans.to(compute_dtype)
    for _ in range(logt):
        trans = torch.bmm(trans, trans)
    trans = trans.float()

    cam_vec = avg_pool2d(cam.float(), 8).reshape(b, c, dh * dw)   # (B, C, hw)
    # reference: cam_rw[k, j] = sum_i cam[k, i] * trans[i, j]
    cam_rw = torch.bmm(cam_vec, trans).reshape(b, c, dh, dw)
    out = resize_bilinear(cam_rw, (h, w), align_corners=False)
    return out[0] if squeeze else out
