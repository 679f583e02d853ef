"""PCM with its pixel rows sharded over a process group (counterpart of
wseg_tpu/parallel/spatial.py:pcm_spatial).

The dense PCM builds the hw x hw pixel affinity of one image; here each rank
holds a contiguous block of the pixel rows, so the affinity it writes is
(hw / W) x hw and an image's resolution can outgrow one card. Each rank
normalises its feature rows, all-gathers the normalised features, computes
its rows of relu(fn_blk fn_all^T), and the column sums and the propagated
partial products are summed over the ranks; each rank returns its own rows.
The epsilons sit where ops/pcm.py puts them, so the result is the dense
PCM's. The products are plain `torch.matmul`s, as they are plain einsums
outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, rank_of


def pcm_spatial(cam: torch.Tensor, f: torch.Tensor, group, eps: float = 1e-5) -> torch.Tensor:
    """cam (N, HW / W, C), f (N, HW / W, Cf) raw f9 features: rank r's rows
    [r HW / W, (r + 1) HW / W) of the flattened pixels (every rank the same
    count). Returns rank r's rows (N, HW / W, C) of the PCM output."""
    blk = f.shape[1]
    fn = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + eps)
    fn_all = all_gather_rows(fn, group, dim=1)  # (N, HW, Cf)
    aff = torch.relu(torch.matmul(fn, fn_all.transpose(1, 2)))  # (N, HW / W, HW)
    colsum = all_reduce_sum(aff.sum(dim=1), group)  # (N, HW)
    out = all_reduce_sum(torch.matmul(aff.transpose(1, 2), cam.to(aff.dtype)), group)
    out = out / (colsum[..., None] + eps)
    start = rank_of(group) * blk
    return out[:, start:start + blk].to(cam.dtype)
