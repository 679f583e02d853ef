"""Radius-neighbourhood pixel pairs for AffinityNet, NCHW (counterpart of
wseg_tpu/ops/pairs.py; reference tool/pyutils.py:125-159 and
network/resnet38_aff.py:53-78).

The pair set of radius r is the "causal half" of the disc: the dy = 0,
dx > 0 row, then the dy > 0 rows with dx^2 + dy^2 < r^2, over a frame
cropped so that every (from, to) pair lies inside the map. A pair's
affinity is exp(-mean_c |f[to] - f[from]|); the dense matrix is symmetric
with a unit diagonal.

The pair indices are host numpy, built once per (radius, size). The
affinities come in two forms with the same output: `pairwise_affinity`
gathers (an (N, C, D*P) temporary), `pairwise_affinity_sliced` takes one
shifted window of the map per displacement. The dense matrix also comes in
two forms with the same output, exactly: a scatter-add
(`dense_affinity_matrix`) and one strided diagonal view per displacement
(`dense_affinity_matrix_banded`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _check_radius(radius: int):
    if radius < 2:
        raise ValueError(
            f"radius {radius} yields an empty pair set; the affinity head "
            f"needs a feature map with min edge >= 5 (input min edge >= 40)"
        )


@functools.lru_cache(maxsize=64)
def search_offsets(radius: int) -> tuple[tuple[int, int], ...]:
    """Half-disc displacements (dy, dx), in the reference's order."""
    dist = [(0, x) for x in range(1, radius)]
    for y in range(1, radius):
        for x in range(-radius + 1, radius):
            if x * x + y * y < radius * radius:
                dist.append((y, x))
    return tuple(dist)


@functools.lru_cache(maxsize=64)
def radius_pair_indices(radius: int, size: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """(indices_from (P,), indices_to (D*P,)) flat pixel indices of an
    (h, w) map: the cropped frame in raster order, then for each
    displacement its shifted frame."""
    _check_radius(radius)
    h, w = size
    rf = radius - 1
    full = np.arange(h * w, dtype=np.int64).reshape(h, w)
    crop_h, crop_w = h - rf, w - 2 * rf
    indices_from = full[:-rf, rf:-rf].reshape(-1)
    to_list = [full[dy:dy + crop_h, rf + dx:rf + dx + crop_w].reshape(-1)
               for dy, dx in search_offsets(radius)]
    return indices_from, np.concatenate(to_list, axis=0)


def pair_index_tensors(radius: int, size: tuple[int, int],
                       device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`radius_pair_indices` as int64 tensors on `device`."""
    ind_from, ind_to = radius_pair_indices(radius, size)
    return torch.from_numpy(ind_from).to(device), torch.from_numpy(ind_to).to(device)


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| whose gradient at 0 is +1, as JAX's abs (select(d >= 0, g, -g));
    torch.abs gives 0 there. Exact ties are common in training: constant pad
    regions of a crop give neighbouring pixels identical features."""
    return torch.where(d >= 0, d, -d)


def pairwise_affinity(f: torch.Tensor, ind_from: torch.Tensor,
                      ind_to: torch.Tensor) -> torch.Tensor:
    """aff = exp(-mean_c |f[to] - f[from]|) by gathers.

    f: (N, C, H, W) map; ind_from (P,), ind_to (D*P,) int64 on f's device.
    Returns (N, D, P)."""
    n, c = f.shape[:2]
    flat = f.reshape(n, c, -1)
    p = ind_from.shape[0]
    ff = flat.index_select(2, ind_from)                        # (N, C, P)
    ft = flat.index_select(2, ind_to).view(n, c, -1, p)       # (N, C, D, P)
    return torch.exp(-_abs(ft - ff[:, :, None]).mean(dim=1))


def pairwise_affinity_sliced(f: torch.Tensor, radius: int) -> torch.Tensor:
    """`pairwise_affinity` over `radius_pair_indices(radius, (H, W))` from
    one shifted window of f (N, C, H, W) per displacement, so no (N, C, D, P)
    temporary exists. Returns (N, D, ch * cw) in the same displacement and
    pixel order."""
    _check_radius(radius)
    h, w = f.shape[-2:]
    rf = radius - 1
    ch, cw = h - rf, w - 2 * rf
    ff = f[:, :, :ch, rf:rf + cw]
    affs = [torch.exp(-_abs(f[:, :, dy:dy + ch, rf + dx:rf + dx + cw] - ff).mean(dim=1))
            for dy, dx in search_offsets(radius)]
    return torch.stack(affs, dim=1).flatten(2)


def dense_affinity_matrix(aff: torch.Tensor, ind_from: torch.Tensor, ind_to: torch.Tensor,
                          area: int) -> torch.Tensor:
    """Symmetric (..., area, area) matrix with a unit diagonal from (..., D, P)
    affinities by scatter-add (network/resnet38_aff.py:65-78): the
    reference's sparse to_dense."""
    lead = aff.shape[:-2]
    aff = aff.reshape(-1, aff.shape[-1] * aff.shape[-2])      # (B, D*P)
    b = aff.shape[0]
    frm = ind_from.repeat(aff.shape[1] // ind_from.shape[0])  # (D*P,) like ind_to
    batch = torch.arange(b, device=aff.device)[:, None].expand_as(aff)
    frm, to = frm.expand_as(aff), ind_to.expand_as(aff)
    mat = aff.new_zeros(b, area, area)
    mat.index_put_((batch, frm, to), aff, accumulate=True)
    mat.index_put_((batch, to, frm), aff, accumulate=True)
    torch.diagonal(mat, dim1=-2, dim2=-1).add_(1.0)
    return mat.reshape(*lead, area, area)


def dense_affinity_matrix_banded(aff: torch.Tensor, radius: int,
                                 size: tuple[int, int]) -> torch.Tensor:
    """`dense_affinity_matrix` without a scatter, equal to it exactly.

    Every pair of displacement (dy, dx) has to - from = dy * w + dx, one
    constant, so the matrix is a sum of |D| diagonal bands: each band is
    written through `torch.diagonal(mat, offset)`. Padding each
    displacement's (crop_h, crop_w) frame back to (h, w) with zeros puts 0 at
    every from-pixel outside the frame, and those include the band's last
    `offset` entries, which the diagonal view does not reach."""
    h, w = size
    area = h * w
    rf = radius - 1
    crop_h, crop_w = h - rf, w - 2 * rf
    lead = aff.shape[:-2]
    a = aff.reshape(-1, aff.shape[-2], crop_h, crop_w)
    a_pad = torch.nn.functional.pad(a, (rf, rf, 0, rf)).flatten(2)   # (B, D, area)
    mat = aff.new_zeros(a.shape[0], area, area)
    for d, (dy, dx) in enumerate(search_offsets(radius)):
        k = dy * w + dx
        vals = a_pad[:, d, :area - k]
        torch.diagonal(mat, offset=k, dim1=-2, dim2=-1).add_(vals)
        torch.diagonal(mat, offset=-k, dim1=-2, dim2=-1).add_(vals)
    torch.diagonal(mat, dim1=-2, dim2=-1).add_(1.0)
    return mat.reshape(*lead, area, area)
