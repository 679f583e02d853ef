"""The accelerator mean-field dense CRF on torch tensors (counterpart of
wseg_tpu/ops/crf.py; the CLIs' `--crf_backend tpu`, which keeps the JAX
package's name). It runs on the caller's `--device`, the CUDA card unless
the caller asks for the CPU, in float32: the callers turn TF32 off, since
the spatial Gaussians and the Nystrom products are the CRF's precision.

* Spatial Gaussian messages: exact dense Gaussian filtering as two separable
  matmuls (H, H) and (W, W).
* Bilateral messages, two methods:
  - "lowrank" (default): Nystrom landmark colour features times the
    SVD-factored exact spatial Gaussian; every step is a dense matmul.
  - "grid": a 5-D bilateral grid (a 32-corner multilinear splat with
    `index_add_`, a [1, 2, 1] / 4 blur per axis, a multilinear slice), kept
    as an independent second approximation. Colour bins are capped (16 per
    channel by default), which coarsens a small srgb.

Both use densecrf's symmetric normalisation (norm = rsqrt(K 1), message =
norm * K(norm * Q)) and the update Q <- softmax(-U + sum_k w_k K_k Q).

`make_crf` is cached by its parameters and device, under a lock that
serialises misses (the CLIs call it from thread pools); the spatial
factors' device copies are cached by (size, sigma, device). `masked=True`
takes the valid (vh, vw) of a bucket-padded input: padded pixels neither
send nor receive messages, so the valid crop equals the unpadded result.
`batch=True` runs a leading unary axis (aff_prepare's alpha sweep) against
one image's colour features.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from wseg_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=64)
def _gauss_matrix_np(size: int, sigma: float) -> np.ndarray:
    idx = np.arange(size, dtype=np.float64)
    d2 = (idx[:, None] - idx[None, :]) ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _gauss_lowrank_np(size: int, sigma: float, tol: float = 1e-4):
    """SVD factor of the 1-D Gaussian kernel matrix: G ~= U @ V.T with
    rank = #singular values above tol * s0 (a wide Gaussian on a short axis
    is numerically low-rank: rank 8 for size 384 at sigma 80)."""
    g = _gauss_matrix_np(size, sigma).astype(np.float64)
    u, s, vt = np.linalg.svd(g)
    r = max(1, int(np.sum(s > s[0] * tol)))
    return (
        np.ascontiguousarray(u[:, :r] * s[:r]).astype(np.float32),
        np.ascontiguousarray(vt[:r].T).astype(np.float32),
    )


@functools.lru_cache(maxsize=128)
def _gauss_matrix(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gauss_matrix_np(size, sigma)).to(device)


@functools.lru_cache(maxsize=128)
def _gauss_lowrank(size: int, sigma: float, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _gauss_lowrank_np(size, sigma))


def _gaussian_filter(q: torch.Tensor, sxy: float) -> torch.Tensor:
    """Exact spatial Gaussian filter of (..., H, W, L) via dense matmuls."""
    h, w = q.shape[-3], q.shape[-2]
    gh = _gauss_matrix(h, sxy, q.device)
    gw = _gauss_matrix(w, sxy, q.device)
    return torch.einsum("ij,...jwl->...iwl", gh, torch.einsum("ab,...hbl->...hal", gw, q))


def _bilateral_grid_filter(q: torch.Tensor, feats: torch.Tensor, grid_shape) -> torch.Tensor:
    """Approximate 5-D Gaussian filter via a bilateral grid.

    q: (P, L) values; feats: (P, 5) features in grid units; grid_shape: 5
    ints. Returns (P, L). The splat's `index_add_` sums in another order
    than the JAX package's scatter-add (atomics on the card)."""
    p, l = q.shape
    d = feats.shape[1]
    lo = torch.floor(feats)
    frac = feats - lo
    lo = lo.to(torch.int64)
    dims = torch.tensor(grid_shape, dtype=torch.int64, device=q.device)
    strides = np.concatenate([np.cumprod(np.asarray(grid_shape[::-1]))[::-1][1:], [1]])
    strides = torch.from_numpy(strides.astype(np.int64)).to(q.device)
    ncells = int(np.prod(grid_shape))

    def corners():
        for corner in range(1 << d):
            offs = torch.tensor([(corner >> i) & 1 for i in range(d)], device=q.device)
            idx = torch.minimum(torch.clamp(lo + offs, min=0), dims - 1)
            flat = (idx * strides).sum(dim=1)
            wgt = torch.where(offs == 1, frac, 1.0 - frac).prod(dim=1)
            yield flat, wgt

    # splat: 2^5 corners with multilinear weights
    grid = torch.zeros((ncells, l), dtype=torch.float32, device=q.device)
    for flat, wgt in corners():
        grid.index_add_(0, flat, wgt[:, None] * q)

    # blur [1, 2, 1] / 4 along each axis, zero boundaries
    g = grid.reshape(*grid_shape, l)
    for axis in range(d):
        size = grid_shape[axis]
        zero = torch.zeros_like(g.narrow(axis, 0, 1))
        up = torch.cat([zero, g.narrow(axis, 0, size - 1)], dim=axis)
        down = torch.cat([g.narrow(axis, 1, size - 1), zero], dim=axis)
        g = 0.5 * g + 0.25 * (up + down)
    grid = g.reshape(ncells, l)

    # slice: multilinear gather
    out = torch.zeros((p, l), dtype=torch.float32, device=q.device)
    for flat, wgt in corners():
        out = out + wgt[:, None] * grid[flat]
    return out


# torch loads its CUDA linear-algebra library on the first linalg call, and two
# threads making that first call at once fail ("lazy wrapper should be called
# at most once"); the CLIs call the CRF from thread pools
_eigh_lock = threading.Lock()


def _lowrank_bilateral_factory(
    image_hw, sxy_bilateral, srgb, n_landmarks, ridge, img, mask, valid_hw, mc
):
    """Build the scatter-free low-rank bilateral operator for one image.

    k_bilateral(i, j) = k_xy(i, j) * k_rgb(ci, cj) factorises; each factor
    is approximated by a low-rank symmetric expansion:

    * colour: Nystrom, k_rgb(ci, cj) ~= psi(ci)^T psi(cj) with psi =
      (K_ZZ + ridge I)^(-1/2) k(Z, c) over M landmark colours Z taken at the
      cell centres of a 2-D stratified grid over the VALID region;
    * space: the 1-D Gaussian matrices SVD-factored at tol 1e-4.

    message(v) = sum_m psi_m .* G_y G_x (psi_m .* v), chunked over m by
    `mc` so the (..., H, W, mc, C) intermediate bounds memory. img (H, W, 3)
    on the CRF's device; the returned function maps (..., H, W, C) to the
    same shape."""
    h, w = image_hw
    dev = img.device
    uy, vy = _gauss_lowrank(h, sxy_bilateral, dev)
    ux, vx = _gauss_lowrank(w, sxy_bilateral, dev)

    colors = img.to(torch.float32) / srgb  # (H, W, 3)
    vh, vw = int(valid_hw[0]), int(valid_hw[1])
    # 2-D stratified landmark sampling: cell centres of a gy x gx grid over
    # the valid region, in the JAX package's integer arithmetic
    gy = int(np.floor(np.sqrt(n_landmarks)))
    gx = -(-n_landmarks // gy)
    k = np.arange(n_landmarks)
    ly = ((k // gx) * 2 + 1) * vh // (2 * gy)
    lx = ((k % gx) * 2 + 1) * vw // (2 * gx)
    z = colors[torch.from_numpy(ly).to(dev), torch.from_numpy(lx).to(dev)]  # (M, 3)
    kzz = torch.exp(-0.5 * ((z[:, None] - z[None]) ** 2).sum(-1))
    eye = torch.eye(n_landmarks, dtype=torch.float32, device=dev)
    with _eigh_lock:
        evals, evecs = torch.linalg.eigh(kzz + ridge * eye)
    inv_sqrt = (evecs * torch.rsqrt(torch.clamp(evals, min=ridge))) @ evecs.T
    kzc = torch.exp(-0.5 * ((z[:, None, None] - colors[None]) ** 2).sum(-1))  # (M, H, W)
    psi = torch.einsum("mn,nhw->hwm", inv_sqrt, kzc)  # (H, W, M)

    def bilateral(v):  # (..., H, W, C) -> (..., H, W, C)
        lead, c = v.shape[:-3], v.shape[-1]
        a = int(np.prod(lead)) if lead else 1
        v = v.reshape(a, h, w, c)
        out = torch.zeros_like(v)
        for c0 in range(0, n_landmarks, mc):
            cc = psi[..., c0:c0 + mc]
            m = cc.shape[-1]
            x = cc[None, ..., :, None] * v[..., None, :]  # (A, H, W, m, C)
            f = vy.T @ x.reshape(a, h, w * m * c)  # "hr,hwmc->rwmc"
            r = f.shape[1]
            f = vx.T @ f.reshape(a * r, w, m * c)  # "ws,rwmc->rsmc"
            s = f.shape[1]
            f = uy @ f.reshape(a, r, s * m * c)  # "hr,rsmc->hsmc"
            f = ux @ f.reshape(a * h, s, m * c)  # "ws,hsmc->hwmc"
            f = f.reshape(a, h, w, m, c)
            out = out + torch.einsum("ahwmc,hwm->ahwc", f, cc)
        return out.reshape(*lead, h, w, c)

    return bilateral


def _grid_bilateral_factory(
    image_hw, sxy_bilateral, srgb, max_color_bins, img, mask, valid_hw, mc
):
    """Build the bilateral-grid operator for one image (mc unused)."""
    h, w = image_hw
    srgb_eff = max(srgb, 255.0 / max_color_bins)
    gx = int(np.ceil((w - 1) / sxy_bilateral)) + 2
    gy = int(np.ceil((h - 1) / sxy_bilateral)) + 2
    gc = int(np.ceil(255.0 / srgb_eff)) + 2
    grid_shape = (gy, gx, gc, gc, gc)

    ys, xs = np.mgrid[0:h, 0:w]
    spatial = np.stack(
        [ys / sxy_bilateral, xs / sxy_bilateral], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    feats = torch.cat(
        [torch.from_numpy(spatial).to(img.device),
         img.reshape(-1, 3).to(torch.float32) / srgb_eff],
        dim=1,
    )

    def bilateral(v):  # (..., H, W, C) -> (..., H, W, C)
        lead, c = v.shape[:-3], v.shape[-1]
        # the alphas share the splat weights: they ride as channels
        vv = v.reshape(-1, h * w, c).permute(1, 0, 2).reshape(h * w, -1)
        out = _bilateral_grid_filter(vv, feats, grid_shape)
        return out.reshape(h * w, -1, c).permute(1, 0, 2).reshape(*lead, h, w, c)

    return bilateral


def _make_crf(
    image_hw: tuple[int, int],
    n_labels: int = 21,
    t: int = 10,
    sxy_gaussian: float = 3.0,
    compat_gaussian: float = 3.0,
    sxy_bilateral: float = 50.0,
    srgb: float = 5.0,
    compat_bilateral: float = 10.0,
    max_color_bins: int = 16,
    method: str = "lowrank",
    n_landmarks: int = 224,
    m_chunk: int = 32,
    ridge: float = 1e-4,
    batch: bool = False,
    masked: bool = False,
    unary_mode: str = "energy",
    gt_prob: float = 0.7,
    device: str | torch.device = "cuda",
):
    """A CRF for a fixed (padded) image size on `device`.

    fn(unary (H, W, L) energies, img (H, W, 3) 0..255) -> (H, W, L) Q, all
    tensors on `device`.
    masked=True  -- fn also takes valid_hw = (vh, vw): pixels outside the
                    top-left valid rectangle neither send nor receive
                    messages (the symmetric normalisation is built from the
                    valid mask), so one bucket shape serves many images.
    batch=True   -- unary carries a leading axis (A, H, W, L) sharing ONE
                    image: the colour features and kernel factors are built
                    once. The landmark chunk is min(m_chunk, max(16, 160 //
                    A)), the JAX package's, so the sums run in its order.
    unary_mode="label" -- fn takes integer label maps (..., H, W); the
                    unary_from_labels energies (`gt_prob`, no unlabeled
                    class) are built on the device.
    """
    device = resolve_device(device)
    h, w = image_hw
    if method == "lowrank":
        factory = functools.partial(
            _lowrank_bilateral_factory, (h, w), sxy_bilateral, srgb, n_landmarks, ridge,
        )

        # Nystrom + SVD truncation can leave tiny negative values where the
        # kernel mass is ~0; clamp before the rsqrt normalisation
        def clamp(x):
            return torch.clamp(x, min=1e-6)
    elif method == "grid":
        factory = functools.partial(
            _grid_bilateral_factory, (h, w), sxy_bilateral, srgb, max_color_bins,
        )

        def clamp(x):
            return x + 1e-20
    else:
        raise ValueError(f"unknown CRF method: {method}")
    p_e, n_e = float(-np.log(gt_prob)), float(-np.log((1.0 - gt_prob) / (n_labels - 1)))

    def core(unary, img, valid_hw, mc):
        vh, vw = int(valid_hw[0]), int(valid_hw[1])
        mask = ((torch.arange(h, device=device)[:, None] < vh)
                & (torch.arange(w, device=device)[None, :] < vw))[..., None].to(torch.float32)
        bilateral = factory(img, mask, (vh, vw), mc)
        # symmetric normalisation over VALID pixels only; folding the mask
        # into the norms zeroes padded inputs before the kernel and padded
        # outputs after it
        norm_g = mask * torch.rsqrt(_gaussian_filter(mask, sxy_gaussian) + 1e-20)
        norm_b = mask * torch.rsqrt(clamp(bilateral(mask)))
        neg_u = -unary
        q = torch.softmax(neg_u, dim=-1)
        for _ in range(t):
            msg = neg_u
            msg = msg + compat_gaussian * norm_g * _gaussian_filter(norm_g * q, sxy_gaussian)
            msg = msg + compat_bilateral * norm_b * bilateral(norm_b * q)
            q = torch.softmax(msg, dim=-1)
        return q

    def run(unary, img, valid_hw=(h, w)):
        if unary_mode == "label":
            onehot = torch.nn.functional.one_hot(unary.to(torch.int64), n_labels)
            unary = n_e + (p_e - n_e) * onehot.to(torch.float32)
        if batch:
            mc = min(m_chunk, max(16, 160 // max(1, unary.shape[0])))
            return core(unary, img, valid_hw, mc)
        return core(unary, img, valid_hw, m_chunk)

    if masked:
        return run
    return lambda unary, img: run(unary, img)


_make_crf_cached = functools.lru_cache(maxsize=32)(_make_crf)
_make_crf_lock = threading.Lock()


@functools.wraps(_make_crf)
def make_crf(*args, **kwargs):
    # serialise cache misses: the CLIs call this from thread pools, and
    # lru_cache does not lock a miss
    if "device" in kwargs:
        kwargs["device"] = resolve_device(kwargs["device"])
    with _make_crf_lock:
        return _make_crf_cached(*args, **kwargs)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def crf_labels_tpu(
    img: np.ndarray, labels: np.ndarray, t: int = 10, n_labels: int = 21,
    gt_prob: float = 0.7, bucket: int = 64, device: str | torch.device = "cuda", **kw,
) -> np.ndarray:
    """Label-unary CRF on `device`; the contract of
    ops.densecrf.crf_inference_labels (returns (L, H, W)). The image is
    padded to `bucket` multiples and run through the cached masked CRF, so a
    corpus of VOC shapes reuses a few bucket CRFs while each image gets its
    unpadded result."""
    return crf_labels_tpu_batch(
        img, labels[None], t=t, n_labels=n_labels, gt_prob=gt_prob,
        bucket=bucket, device=device, **kw,
    )[0]


def crf_labels_tpu_batch(
    img: np.ndarray, labels: np.ndarray, t: int = 10, n_labels: int = 21,
    gt_prob: float = 0.7, bucket: int = 64, device: str | torch.device = "cuda", **kw,
) -> np.ndarray:
    """Label-unary CRF for A labellings of ONE image (aff_prepare's alpha
    sweep): labels (A, H, W) -> (A, L, H, W). The image's colour features
    are built once for the whole sweep."""
    device = resolve_device(device)
    a, h, w = labels.shape
    hp, wp = _round_up(h, bucket), _round_up(w, bucket)
    labels_p = np.zeros((a, hp, wp), np.uint8)
    labels_p[:, :h, :w] = labels
    img_p = np.zeros((hp, wp, 3), np.uint8)
    img_p[:h, :w] = img
    run = make_crf(
        (hp, wp), n_labels=n_labels, t=t, batch=True, masked=True,
        unary_mode="label", gt_prob=gt_prob, device=device, **kw,
    )
    q = run(torch.from_numpy(labels_p).to(device), torch.from_numpy(img_p).to(device), (h, w))
    return np.ascontiguousarray(q[:, :h, :w].permute(0, 3, 1, 2).cpu().numpy())


def crf_softmax_tpu(
    img: np.ndarray, probs: np.ndarray, t: int = 10, n_labels: int = 21,
    bucket: int = 64, device: str | torch.device = "cuda", **kw,
) -> np.ndarray:
    """Softmax-unary CRF on `device`; the contract of
    ops.densecrf.crf_inference_softmax (probs (L, H, W) -> (L, H, W)).
    Unary energies are -log(prob); padded pixels carry zero energies and,
    masked out of the normalisation, neither send nor receive messages."""
    device = resolve_device(device)
    l, h, w = probs.shape
    hp, wp = _round_up(h, bucket), _round_up(w, bucket)
    unary_p = np.zeros((hp, wp, l), np.float32)
    unary_p[:h, :w] = -np.log(np.clip(np.transpose(probs, (1, 2, 0)), 1e-8, None))
    img_p = np.zeros((hp, wp, 3), np.uint8)
    img_p[:h, :w] = img
    run = make_crf((hp, wp), n_labels=n_labels, t=t, masked=True, device=device, **kw)
    q = run(torch.from_numpy(unary_p).to(device), torch.from_numpy(img_p).to(device), (h, w))
    return np.ascontiguousarray(q[:h, :w].permute(2, 0, 1).cpu().numpy())


def dense_crf_tpu(
    probs: np.ndarray, img: np.ndarray, n_classes: int = 21, n_iters: int = 1,
    scale_factor: float = 1, device: str | torch.device = "cuda",
) -> np.ndarray:
    """The stage-3 test-time CRF on `device`, twin of ops.densecrf.dense_crf
    (segmentation/lib/utils/DenseCRF.py:5-39 of the reference: softmax
    unary, Gaussian sxy 3 / compat 3, bilateral sxy 32 / srgb 13 / compat
    10, one iteration)."""
    return crf_softmax_tpu(
        img, probs, t=n_iters, n_labels=n_classes, device=device,
        sxy_gaussian=3 / scale_factor, compat_gaussian=3,
        sxy_bilateral=32 / scale_factor, srgb=13, compat_bilateral=10,
    )
