"""Dense CRF on the host: the port's own ctypes binding of the native
permutohedral mean-field CRF in native/densecrf/ (counterpart of
wseg_tpu/ops/densecrf.py, which cannot be imported without JAX).

The fully-connected Potts CRF with a spatial Gaussian and a bilateral
kernel, and the call sites' parameterisations:
* `crf_inference_labels` / `crf_inference_labels_multi`: a label unary with
  gt_prob (pydensecrf's `unary_from_labels`; contrast_infer.py:115-126 and
  aff_prepare.py:34-50 of the reference);
* `crf_inference_softmax` and `dense_crf`: a softmax unary
  (tool/imutils.py:220-237, segmentation/lib/utils/DenseCRF.py:5-39).

The library is built on first use with g++ and the flags of
native/densecrf/Makefile into `<repo>/build/wseg_tpu_torch/`, named by a
hash of the two sources, the flags and the host CPU's feature flags
(`-march=native`); native/ is only read. The ctypes calls release the GIL,
so images can be CRF'd from a thread pool.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native" / "densecrf"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wseg_tpu_torch"
SOURCES = ("densecrf.cc", "permutohedral.h")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_ubyte)
_c_int, _c_float = ctypes.c_int, ctypes.c_float


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libwseg_densecrf_{h.hexdigest()[:16]}.so"


@functools.cache
def _load() -> ctypes.CDLL:
    with _lock:
        target = library_path()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                   str(NATIVE_DIR / "densecrf.cc")]
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the native CRF failed (rc {out.returncode}):\n"
                                   f"{out.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
    crf_args = [_c_int, _c_float, _c_float, _c_float, _c_float, _c_float, _f32p]
    lib.wseg_densecrf_inference.argtypes = [_c_int, _c_int, _c_int, _f32p, _u8p] + crf_args
    lib.wseg_densecrf_inference.restype = None
    lib.wseg_densecrf_inference_multi.argtypes = [_c_int] * 4 + [_f32p, _u8p] + crf_args
    lib.wseg_densecrf_inference_multi.restype = None
    lib.wseg_permutohedral_filter.argtypes = [_f32p, _c_int, _c_int, _f32p, _c_int, _f32p]
    lib.wseg_permutohedral_filter.restype = None
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _rgb(img: np.ndarray | None, h: int, w: int):
    if img is None:
        return None, None
    img = np.ascontiguousarray(img, np.uint8)
    if img.shape != (h, w, 3):
        raise ValueError(f"image of shape {img.shape}, expected {(h, w, 3)}")
    return img, img.ctypes.data_as(_u8p)


def permutohedral_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Gaussian-filter `values` (n, v) over `features` (n, d)."""
    features = np.ascontiguousarray(features, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    n, d = features.shape
    if values.shape[0] != n:
        raise ValueError(f"{values.shape[0]} values for {n} feature rows")
    out = np.empty_like(values)
    _load().wseg_permutohedral_filter(_fp(features), d, n, _fp(values), values.shape[1],
                                      _fp(out))
    return out


def _inference_multi(unary_anl: np.ndarray, img: np.ndarray | None, t: int,
                     gaussian_sxy: float, gaussian_compat: float, bilateral_sxy: float,
                     bilateral_srgb: float, bilateral_compat: float,
                     h: int, w: int) -> np.ndarray:
    """A unary fields (A, H*W, L) of energies over one image, sharing its
    lattice builds; returns the (A, H*W, L) marginals, bit-identical to A
    single calls."""
    unary_anl = np.ascontiguousarray(unary_anl, np.float32)
    a, n, n_labels = unary_anl.shape
    if n != h * w:
        raise ValueError(f"unary of {n} pixels for a {h}x{w} image")
    img, rgb_ptr = _rgb(img, h, w)
    out = np.empty_like(unary_anl)
    _load().wseg_densecrf_inference_multi(
        h, w, n_labels, a, _fp(unary_anl), rgb_ptr, t,
        gaussian_sxy, gaussian_compat, bilateral_sxy, bilateral_srgb, bilateral_compat,
        _fp(out))
    return out


def unary_from_labels(labels: np.ndarray, n_labels: int, gt_prob: float) -> np.ndarray:
    """(H*W, L) energy = -log P of a hard labelling (pydensecrf's
    `unary_from_labels` with zero_unsure=False)."""
    h, w = labels.shape
    u = np.full((h * w, n_labels), -np.log((1.0 - gt_prob) / (n_labels - 1)), np.float32)
    u[np.arange(h * w), labels.reshape(-1).astype(np.int64)] = -np.log(gt_prob)
    return u


def unary_from_softmax(probs: np.ndarray) -> np.ndarray:
    """(L, H, W) probabilities -> (H*W, L) energy = -log p."""
    n_labels = probs.shape[0]
    return np.ascontiguousarray(
        -np.log(np.clip(probs, 1e-20, None)).reshape(n_labels, -1).T)


def crf_inference_labels_multi(
    img: np.ndarray, labels_stack: np.ndarray, t: int = 10, n_labels: int = 21,
    gt_prob: float = 0.7, sxy_gaussian: float = 3, compat_gaussian: float = 3,
    sxy_bilateral: float = 50, srgb: float = 5, compat_bilateral: float = 10,
) -> np.ndarray:
    """Label-unary CRF of A labellings (A, H, W) of one image (aff_prepare's
    alpha sweep), sharing the lattice builds. Returns (A, L, H, W) marginals,
    bit-identical to A `crf_inference_labels` calls."""
    a, h, w = labels_stack.shape
    unary = np.stack([unary_from_labels(lab, n_labels, gt_prob) for lab in labels_stack])
    q = _inference_multi(unary, img, t, sxy_gaussian, compat_gaussian, sxy_bilateral, srgb,
                         compat_bilateral, h, w)
    return np.ascontiguousarray(q.transpose(0, 2, 1).reshape(a, n_labels, h, w))


def crf_inference_labels(
    img: np.ndarray, labels: np.ndarray, t: int = 10, n_labels: int = 21,
    gt_prob: float = 0.7, sxy_gaussian: float = 3, compat_gaussian: float = 3,
    sxy_bilateral: float = 50, srgb: float = 5, compat_bilateral: float = 10,
) -> np.ndarray:
    """Label-unary CRF (contrast_infer.py:115-126's parameterisation; pass
    sxy_bilateral=80, srgb=13 for aff_prepare.py:34-50's). Returns (L, H, W)
    marginals."""
    return crf_inference_labels_multi(
        img, labels[None], t, n_labels, gt_prob, sxy_gaussian, compat_gaussian,
        sxy_bilateral, srgb, compat_bilateral)[0]


def crf_inference_softmax(
    img: np.ndarray, probs: np.ndarray, t: int = 10, scale_factor: float = 1,
    labels: int = 21, sxy_gaussian: float = 3, compat_gaussian: float = 3,
    sxy_bilateral: float = 80, srgb: float = 13, compat_bilateral: float = 10,
) -> np.ndarray:
    """Softmax-unary CRF (tool/imutils.py:220-237: sxy 80 / scale, srgb 13)
    of (L, H, W) probabilities. Returns (L, H, W) marginals."""
    h, w = img.shape[:2]
    q = _inference_multi(unary_from_softmax(probs)[None], img, t,
                         sxy_gaussian / scale_factor, compat_gaussian,
                         sxy_bilateral / scale_factor, srgb, compat_bilateral, h, w)[0]
    return np.ascontiguousarray(q.T.reshape(labels, h, w))


def dense_crf(probs: np.ndarray, img: np.ndarray, n_classes: int = 21, n_iters: int = 1,
              scale_factor: float = 1) -> np.ndarray:
    """The stage-3 test-time CRF (segmentation/lib/utils/DenseCRF.py:5-39):
    softmax unary, Gaussian sxy 3 / compat 3, bilateral sxy 32 / srgb 13 /
    compat 10, one mean-field iteration by default. probs (C, H, W), img
    (H, W, 3) uint8."""
    return crf_inference_softmax(img, probs, t=n_iters, scale_factor=scale_factor,
                                 labels=n_classes, sxy_bilateral=32)
