"""Bilinear / bicubic resize with torch-compatible semantics, NCHW.

The interpolation matrices are built once on the host in float64 numpy (the
same functions as the JAX package) and cached per (sizes, device) as float32
device tensors; each resize is then two small matmuls, separable along H and
W. Inputs are (N, C, H, W) or (C, H, W); the spatial dims are the last two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_weights_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear-interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    elif align_corners:  # out_size == 1
        src = np.zeros((1,), dtype=np.float64)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        # torch clamps the source coordinate into the valid range, which for
        # bilinear is equivalent to clamping the gather indices
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


@functools.lru_cache(maxsize=256)
def _composed_weights_np(
    in_size: int, mid_size: int, out_size: int, ac1: bool, ac2: bool
) -> np.ndarray:
    """(out, in) matrix of resize(in->mid, ac1) followed by resize(mid->out,
    ac2), precomposed: W = W2 @ W1 applies both steps in one matmul, with no
    mid-size intermediate (4x the output at CAM scale 2)."""
    w1 = _resize_weights_np(in_size, mid_size, ac1).astype(np.float64)
    w2 = _resize_weights_np(mid_size, out_size, ac2).astype(np.float64)
    return (w2 @ w1).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _bicubic_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) PIL.Image.BICUBIC-equivalent resampling matrix: Keys cubic
    (a = -0.5) with PIL's antialiasing (filter support scaled by the
    downscale factor) and per-row weight normalization."""

    def cubic(x):
        x = np.abs(x)
        a = -0.5
        return np.where(
            x <= 1,
            (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
        )

    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), in_size)
        js = np.arange(lo, hi)
        ws = cubic((js + 0.5 - center) / fscale)
        s = ws.sum()
        if s != 0:
            w[i, lo:hi] = ws / s
    return w.astype(np.float32)


@functools.lru_cache(maxsize=512)
def _device_weights(make_weights, args: tuple, device: torch.device) -> torch.Tensor:
    """One host->device copy per (matrix, device), reused by every call. The
    copy is a normal tensor even when the first call runs under
    torch.inference_mode(), so a later training step can reuse it."""
    with torch.inference_mode(False):
        return torch.from_numpy(make_weights(*args)).to(device)


def _separable(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """Apply (oh, h) along H and (ow, w) along W to NCHW/CHW in float32."""
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    return torch.einsum("pw,...ow->...op", ww, y)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear-resize the last two dims of (N, C, H, W) or (C, H, W) to
    `out_hw`, equal to F.interpolate(mode='bilinear') in both modes. Computes
    in float32 and returns x's dtype."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    ac = bool(align_corners)
    wh = _device_weights(_resize_weights_np, (h, oh, ac), x.device)
    ww = _device_weights(_resize_weights_np, (w, ow, ac), x.device)
    return _separable(x, wh, ww).to(x.dtype)


def resize_bilinear_chain(
    x: torch.Tensor, mid_hw: tuple[int, int], out_hw: tuple[int, int],
    align1: bool = True, align2: bool = False,
) -> torch.Tensor:
    """resize(resize(x, mid_hw, align1), out_hw, align2) as one composed
    resize (the same linear map, reassociated)."""
    h, w = x.shape[-2:]
    mh, mw = int(mid_hw[0]), int(mid_hw[1])
    oh, ow = int(out_hw[0]), int(out_hw[1])
    wh = _device_weights(_composed_weights_np, (h, mh, oh, bool(align1), bool(align2)), x.device)
    ww = _device_weights(_composed_weights_np, (w, mw, ow, bool(align1), bool(align2)), x.device)
    return _separable(x, wh, ww).to(x.dtype)


def _valid_linear_weights(
    valid_in: torch.Tensor, valid_out: torch.Tensor, in_size: int, out_size: int,
    align_corners: bool,
) -> torch.Tensor:
    """(N, out_size, in_size) per-sample bilinear weight matrices for valid
    regions inside padded buffers: for sample n only rows < valid_out[n] and
    cols < valid_in[n] are nonzero, and that block equals
    `_resize_weights_np(valid_in[n], valid_out[n], align_corners)`. Built with
    iota arithmetic on the device, one matrix per sample."""
    dev = valid_in.device
    vi = valid_in.float()[:, None]  # (N, 1)
    vo = valid_out.float()[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None]  # (1, O)
    if align_corners:
        src = o * (vi - 1.0) / torch.clamp(vo - 1.0, min=1.0)
        src = torch.where(vo > 1.0, src, torch.zeros_like(src))
    else:
        src = (o + 0.5) * (vi / vo) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), vi - 1.0)  # (N, O)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)[None, None]  # (1, 1, I)
    w = torch.clamp(1.0 - torch.abs(i - src[:, :, None]), min=0.0)  # tent
    w = w * (i < vi[:, :, None])  # cols beyond valid_in
    w = w * (o[..., None] < vo[:, :, None])  # rows beyond valid_out
    return w


def resize_bilinear_valid(
    x: torch.Tensor, out_hw: tuple[int, int], valid_in: torch.Tensor,
    valid_out: torch.Tensor, align_corners: bool = True,
) -> torch.Tensor:
    """Per-sample valid-region bilinear resize inside padded buffers.

    x: (N, C, H, W) where sample n's content is x[n, :, :valid_in[n, 0],
    :valid_in[n, 1]] and the rest is padding; valid_in / valid_out are (N, 2)
    integer tensors. Each sample's [:valid_out[n, 0], :valid_out[n, 1]] block
    of the (N, C, *out_hw) result equals `resize_bilinear` of its valid
    region; everything else is zero."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    wh = _valid_linear_weights(valid_in[:, 0], valid_out[:, 0], h, oh, align_corners)
    ww = _valid_linear_weights(valid_in[:, 1], valid_out[:, 1], w, ow, align_corners)
    y = torch.einsum("noh,nchw->ncow", wh, x.float())
    y = torch.einsum("npw,ncow->ncop", ww, y)
    return y.to(x.dtype)


def avg_pool2d(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Non-overlapping k x k mean over the last two dims of (N, C, H, W) or
    (C, H, W), both divisible by k: F.avg_pool2d(x, k, k) (aff_infer.py:113
    of the reference)."""
    h, w = x.shape[-2:]
    if h % ksize or w % ksize:
        raise ValueError(f"avg_pool2d: {h}x{w} is not divisible by {ksize}")
    y = x.reshape(*x.shape[:-2], h // ksize, ksize, w // ksize, ksize)
    return y.mean(dim=(-3, -1))


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int],
                   uint8_rounding: bool = True) -> torch.Tensor:
    """PIL-BICUBIC-equivalent resize of the last two dims (antialiased on
    downscale). `uint8_rounding=True` reproduces PIL's horizontal-then-
    vertical pass order with the intermediate clipped and rounded to uint8.
    Returns float32 in 0..255 units."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x.float()
    wh = _device_weights(_bicubic_weights_np, (h, oh), x.device)
    ww = _device_weights(_bicubic_weights_np, (w, ow), x.device)
    y = torch.einsum("pw,...hw->...hp", ww, x.float())  # horizontal
    if uint8_rounding:
        y = torch.clamp(torch.round(y), 0.0, 255.0)
    y = torch.einsum("oh,...hp->...op", wh, y)  # vertical
    if uint8_rounding:
        y = torch.clamp(torch.round(y), 0.0, 255.0)
    return y
