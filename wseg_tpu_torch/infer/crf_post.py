"""CRF post-processing for the inference CLIs, on the host's native CRF
(counterpart of wseg_tpu/infer/crf_post.py).

* `crf_from_cam_dict` (contrast_infer.py:102-134 of the reference): the
  21-channel score map of a cam dict with a constant background score, its
  argmax as a hard labelling, the label-unary CRF (gt_prob .7, Gaussian
  sxy 3 / compat 3, bilateral sxy 50 / srgb 5 / compat 10), the argmax png.
* `crf_with_alpha` (aff_prepare.py:53-73): background (1 - max cam)^alpha,
  the label-unary CRF with AdvCAM's parameters (`AFF_CRF_PARAMS`), the
  (21, H, W) scores. `crf_with_alpha_sweep` runs a list of alphas for one
  image, sharing its lattice builds.

backend "native" is the C++ permutohedral CRF (ops/densecrf.py) on the
host. Backend "tpu" (the JAX package's name for it) is the accelerator CRF
(ops/crf.py: Nystrom colour x SVD-factored spatial Gaussian) on `device`,
the CUDA card unless the caller asks for the CPU; the alpha sweep is one
batched call an image. Neither falls back to the other.
"""

from __future__ import annotations

import os

import numpy as np

from wseg_tpu_torch.infer.cam import write_png
from wseg_tpu_torch.ops.crf import crf_labels_tpu, crf_labels_tpu_batch
from wseg_tpu_torch.ops.densecrf import crf_inference_labels, crf_inference_labels_multi

AFF_CRF_PARAMS = dict(  # AdvCAM's parameterisation, aff_prepare.py:34-50
    sxy_gaussian=3, compat_gaussian=3,
    sxy_bilateral=80, srgb=13, compat_bilateral=10,
)
CAM_CRF_PARAMS = dict(  # contrast_infer.py:115-126
    sxy_gaussian=3, compat_gaussian=3,
    sxy_bilateral=50, srgb=5, compat_bilateral=10,
)
BACKENDS = ("native", "tpu")


def check_backend(backend: str):
    """Raise unless `backend` names a CRF."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown CRF backend {backend!r}; expected one of {BACKENDS}")


def _load_rgb(img_path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(img_path) as im:
        return np.array(im.convert("RGB"))


def _scores(cam_dict: dict, n_labels: int = 21) -> np.ndarray:
    """(n_labels, H, W) with each cam at its class + 1 and 0 in channel 0."""
    h, w = next(iter(cam_dict.values())).shape
    tensor = np.zeros((n_labels, h, w), np.float32)
    for key, cam in cam_dict.items():
        tensor[key + 1] = cam
    return tensor


def crf_from_cam_dict(cam_dict: dict, img_path: str, out_path: str, bg_score: float = 0.26,
                      t: int = 10, gt_prob: float = 0.7, backend: str = "native",
                      device: str = "cuda") -> np.ndarray:
    """The CRF'd argmax (H, W) uint8 of one cam dict, also written to
    `out_path` as a png. `device` is the tpu backend's."""
    check_backend(backend)
    tensor = _scores(cam_dict)
    tensor[0] = bg_score
    predict = np.argmax(tensor, axis=0).astype(np.uint8)
    if backend == "tpu":
        crf_score = crf_labels_tpu(_load_rgb(img_path), predict, t=t, gt_prob=gt_prob,
                                   device=device, **CAM_CRF_PARAMS)
    else:
        crf_score = crf_inference_labels(_load_rgb(img_path), predict, t=t, gt_prob=gt_prob,
                                         **CAM_CRF_PARAMS)
    pred = np.argmax(crf_score, axis=0).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, pred)
    return pred


def _alpha_seed(cam_dict: dict, alpha: float) -> np.ndarray:
    """The argmax seed labelling at background (1 - max cam)^alpha
    (aff_prepare.py:62-66)."""
    tensor = _scores(cam_dict)
    tensor[0] = np.power(1 - np.max(tensor, axis=0), alpha)
    return np.argmax(tensor, axis=0).astype(np.uint8)


def crf_with_alpha(cam_dict: dict, img_path: str, alpha: float, t: int = 10,
                   gt_prob: float = 0.7, backend: str = "native",
                   device: str = "cuda") -> np.ndarray:
    """(21, H, W) CRF scores of one image at background alpha `alpha`."""
    return crf_with_alpha_sweep(cam_dict, img_path, [alpha], t, gt_prob, backend, device)[0]


def crf_with_alpha_sweep(cam_dict: dict, img_path: str, alphas, t: int = 10,
                         gt_prob: float = 0.7, backend: str = "native",
                         device: str = "cuda") -> list[np.ndarray]:
    """[(21, H, W) CRF scores for each alpha] of one image. Native: the
    alphas share the image's lattice builds, bit-identical to
    `crf_with_alpha` per alpha. tpu: one batched call on `device`, the alphas
    sharing the image's colour features."""
    check_backend(backend)
    seeds = np.stack([_alpha_seed(cam_dict, a) for a in alphas])
    if backend == "tpu":
        return list(crf_labels_tpu_batch(_load_rgb(img_path), seeds, t=t, gt_prob=gt_prob,
                                         device=device, **AFF_CRF_PARAMS))
    return list(crf_inference_labels_multi(_load_rgb(img_path), seeds, t=t, gt_prob=gt_prob,
                                           **AFF_CRF_PARAMS))
