"""Multi-scale + flip CAM inference (counterpart of wseg_tpu/infer/cam.py).

Each image's 8 views (scales {0.5, 1, 1.5, 2} x {orig, flip}) run as one
batch per scale. The stride-8 PCM-refined CAM is cropped to the valid
region, upsampled to the original size through the composed chain
(stride-8 -> view, align_corners=True -> original, align_corners=False, as
one matmul pair), flipped back, label-masked, summed over views and
min/max-normalized (reference contrast_infer.py:38-99).

* `CamInferencer` — images of any size: exact shapes, or padded to a
  bucket with per-sample valid masks; `infer_batch` for several images.
* `make_fused_msf_fn` — uniform-size batches: one model call per scale.

Everything runs on the model's device under torch.inference_mode().
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wseg_tpu_torch.models.resnet38 import IMAGENET_MEAN, IMAGENET_STD
from wseg_tpu_torch.ops.cam import fuse_msf_cams
from wseg_tpu_torch.ops.resize import resize_bicubic, resize_bilinear_chain
from wseg_tpu_torch.parallel.mesh import broadcast_module
from wseg_tpu_torch.utils.profiling import count, span

DEFAULT_SCALES = (0.5, 1.0, 1.5, 2.0)

# Largest view-pixel volume (batch * 2 flips * h * w) one backbone call may
# carry; bigger batches of a scale run as equal chunks. The value is the JAX
# package's (sized for a 16 GB TPU) and is kept until it is re-derived for the
# H100's 80 GB by measurement.
MAX_VIEW_PX = 2 * 24 * 768 * 1024


def _ceil8(x: int) -> int:
    return -(-x // 8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _view_chunks(b: int, h: int, w: int, max_px: int, chunk_mult: int = 1) -> int:
    """Number of equal batch chunks a (b, 2, h, w) view call needs to stay
    under `max_px` pixels; always divides `b` evenly and keeps each chunk a
    multiple of `chunk_mult`. Best effort: if even the smallest legal chunk
    blows the cap, that chunking is returned."""
    n = max(1, -(-(b * 2 * h * w) // max_px))
    while n < b:
        if b % n == 0 and (b // n) % chunk_mult == 0:
            return n
        n += 1
    return b // chunk_mult if chunk_mult > 1 and b % chunk_mult == 0 else b


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _model_dtype(model: torch.nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def _nchw(views_nhwc: np.ndarray) -> torch.Tensor:
    """Host (N, H, W, 3) views -> an NCHW tensor view."""
    return torch.from_numpy(np.ascontiguousarray(views_nhwc)).permute(0, 3, 1, 2)


def _to_input(t: torch.Tensor, model: torch.nn.Module) -> torch.Tensor:
    """NCHW views -> the model's device, dtype and (on CUDA) channels_last
    memory format."""
    t = t.to(_model_device(model), _model_dtype(model))
    if t.is_cuda:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


class CamInferencer:
    """MSF CAM inference of images of any size.

    bucket: pad H, W up to a multiple and pass per-sample valid sizes (the
    pad halo is kept out of every global interaction, so the result equals
    the exact-shape forward); None runs exact shapes. The model is used in
    eval mode on its own device and dtype.

    group: data-parallel inference over a process group (parallel/mesh.py):
    every rank's weights become rank 0's. Each rank then infers its own
    images (the CLI gives it `shard_indices`' block of the list)."""

    def __init__(self, model: torch.nn.Module, scales=DEFAULT_SCALES,
                 bucket: int | None = 64, max_view_px: int | None = None, group=None):
        self.model = model.eval()
        self.scales = scales
        self.bucket = bucket
        self.max_view_px = MAX_VIEW_PX if max_view_px is None else max_view_px
        self.device = _model_device(model)
        broadcast_module(model, group)

    def _forward(self, imgs: torch.Tensor, valid_hw: torch.Tensor | None = None):
        """Stride-8 PCM-refined fg CAM (N, 20, h8, w8) in float32."""
        _, cam_rv_down = self.model(imgs, raw_cam=True, valid_hw=valid_hw)
        return cam_rv_down[:, 1:].float()

    def _fuse(self, total: torch.Tensor, label) -> np.ndarray:
        with span("cam.fuse"):
            label = torch.as_tensor(np.asarray(label), dtype=torch.float32, device=self.device)
            return fuse_msf_cams(total * label[:, None, None]).cpu().numpy()

    @torch.inference_mode()
    def infer_one_device(self, img_uint8: np.ndarray, label: np.ndarray) -> np.ndarray:
        """The whole per-image pipeline on the device: uint8 (H, W, 3) in,
        PIL-equivalent bicubic view scaling, normalization, both flips, all
        scales and the fusion. Returns the fused fg CAM (20, H, W)."""
        with span("cam.batch"):
            h, w = img_uint8.shape[:2]
            dev = self.device
            mean = torch.tensor(IMAGENET_MEAN, device=dev)[:, None, None] * 255.0
            std = torch.tensor(IMAGENET_STD, device=dev)[:, None, None] * 255.0
            with span("cam.h2d"):
                base = torch.as_tensor(np.asarray(img_uint8)).to(dev).permute(2, 0, 1).float()
            total = torch.zeros((20, h, w), dtype=torch.float32, device=dev)
            for s in self.scales:
                th, tw = round(h * s), round(w * s)
                view = (resize_bicubic(base, (th, tw)) - mean) / std
                pair = _to_input(torch.stack([view, view.flip(-1)]), self.model)
                count("cam.view_px", 2 * th * tw)
                count("cam.valid_px", 2 * th * tw)
                with span("cam.forward"):
                    cam = self._forward(pair)
                with span("cam.upsample"):
                    cam = resize_bilinear_chain(cam, (th, tw), (h, w))
                    total += cam[0] + cam[1].flip(-1)
            return self._fuse(total, label)

    @torch.inference_mode()
    def infer_one(self, views: list[np.ndarray], label: np.ndarray,
                  orig_hw: tuple[int, int]) -> np.ndarray:
        """views: 8 HWC float32 arrays ([s, s_flip] per scale, normalized);
        label: (20,). Returns the fused fg CAM (20, H, W)."""
        with span("cam.batch"):
            h0, w0 = orig_hw
            total = torch.zeros((20, h0, w0), dtype=torch.float32, device=self.device)
            for si in range(len(views) // 2):
                with span("cam.assemble"):
                    pair = np.stack([views[2 * si], views[2 * si + 1]])  # (2, h, w, 3)
                    h, w = pair.shape[1:3]
                    if self.bucket:
                        ph, pw = _round_up(h, self.bucket), _round_up(w, self.bucket)
                        pair = np.pad(pair, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
                count("cam.view_px", pair.shape[0] * pair.shape[1] * pair.shape[2])
                count("cam.valid_px", 2 * h * w)
                with span("cam.h2d"):
                    x = _to_input(_nchw(pair), self.model)
                    valid = (torch.tensor([[h, w], [h, w]], device=self.device)
                             if self.bucket else None)
                with span("cam.forward"):
                    cam = self._forward(x, valid)
                with span("cam.upsample"):
                    cam = resize_bilinear_chain(cam[:, :, : _ceil8(h), : _ceil8(w)], (h, w),
                                                (h0, w0))
                    total += cam[0] + cam[1].flip(-1)
            return self._fuse(total, label)

    @torch.inference_mode()
    def infer_batch(self, items: list[tuple[list[np.ndarray], np.ndarray, tuple[int, int]]]
                    ) -> list[np.ndarray]:
        """MSF inference of several images of different sizes: per scale,
        every image's flip pair is zero-padded into one bucketed batch with
        per-sample valid sizes. Outputs equal per-image `infer_one` calls.

        items: [(views, label, orig_hw), ...]; returns [fused (20, H, W), ...].
        """
        if not items:
            return []
        with span("cam.batch"):
            bucket = self.bucket or 8
            b = len(items)
            totals = [torch.zeros((20, *it[2]), dtype=torch.float32, device=self.device)
                      for it in items]
            for si in range(len(self.scales)):
                with span("cam.assemble"):
                    pairs = [np.stack([it[0][2 * si], it[0][2 * si + 1]]) for it in items]
                    hs = [p.shape[1] for p in pairs]
                    ws = [p.shape[2] for p in pairs]
                    ph, pw = _round_up(max(hs), bucket), _round_up(max(ws), bucket)
                    batch = np.zeros((b * 2, ph, pw, 3), np.float32)
                    valid = np.zeros((b * 2, 2), np.int64)
                    for i, p in enumerate(pairs):
                        batch[2 * i : 2 * i + 2, : hs[i], : ws[i]] = p
                        valid[2 * i : 2 * i + 2] = (hs[i], ws[i])
                n_chunks = _view_chunks(b, ph, pw, self.max_view_px)
                m = b // n_chunks
                cams = []
                for ci in range(n_chunks):
                    lo, hi = 2 * ci * m, 2 * (ci + 1) * m
                    count("cam.view_px", (hi - lo) * ph * pw)
                    count("cam.valid_px", int(valid[lo:hi].prod(1).sum()))
                    with span("cam.h2d"):
                        x = _to_input(_nchw(batch[lo:hi]), self.model)
                        v = torch.as_tensor(valid[lo:hi], device=self.device)
                    with span("cam.forward"):
                        cams.append(self._forward(x, v))
                cam = torch.cat(cams)
                with span("cam.upsample"):
                    for i in range(b):
                        h, w, (h0, w0) = hs[i], ws[i], items[i][2]
                        cv = cam[2 * i : 2 * i + 2, :, : _ceil8(h), : _ceil8(w)]
                        up = resize_bilinear_chain(cv, (h, w), (h0, w0))
                        totals[i] += up[0] + up[1].flip(-1)
            return [self._fuse(t, it[1]) for t, it in zip(totals, items)]


def make_fused_msf_fn(model: torch.nn.Module, orig_hw: tuple[int, int],
                      scales=DEFAULT_SCALES, max_view_px: int = MAX_VIEW_PX):
    """MSF inference of a batch of equal-size images: one model call per
    scale (the flip pair as one batch; a scale whose batch exceeds
    `max_view_px` pixels runs as equal chunks), the composed resize chain
    and flip-back per scale, then the label mask and min/max fusion.

    The backbone runs in the model's dtype (bf16 allowed); the CAM resize and
    fusion always run in float32 (max-norm of near-ties is sensitive).

    Returns fn(views, label): views a tuple over scales of (B, 2, 3, h_s, w_s)
    tensors, label (B, 20) -> (B, 20, H, W) float32."""
    h0, w0 = orig_hw
    model = model.eval()

    def per_scale(v: torch.Tensor) -> torch.Tensor:
        b, _, _, h, w = v.shape
        n_chunks = _view_chunks(b, h, w, max_view_px)
        outs = []
        for chunk in v.chunk(n_chunks):
            c = chunk.shape[0]
            pair = _to_input(chunk.reshape(c * 2, 3, h, w), model)
            _, cam_rv_down = model(pair, raw_cam=True)
            cam = resize_bilinear_chain(cam_rv_down[:, 1:].float(), (h, w), (h0, w0))
            cam = cam.reshape(c, 2, 20, h0, w0)
            outs.append(cam[:, 0] + cam[:, 1].flip(-1))
        return torch.cat(outs)

    @torch.inference_mode()
    def fn(views, label: torch.Tensor) -> torch.Tensor:
        total = None
        for v in views:
            part = per_scale(v)
            total = part if total is None else total + part
        label = label.to(total.device, torch.float32)
        return fuse_msf_cams(total * label[:, :, None, None])

    return fn


# ---------------------------------------------------------------------------
# Output writers: the file contracts stage 2 reads (byte-compatible with the
# JAX package and the reference's contrast_infer.py:82-99)
# ---------------------------------------------------------------------------


def write_png(path: str, label: np.ndarray):
    """An (H, W) uint8 label map as a greyscale png (PIL: the card's machine
    has no imageio)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(label, np.uint8)).save(path)


def save_cam_dict(out_dir: str, name: str, norm_cam: np.ndarray, label: np.ndarray):
    """{class_idx: (H, W) float32} for present classes -> <name>.npy."""
    os.makedirs(out_dir, exist_ok=True)
    cam_dict = {i: norm_cam[i] for i in range(20) if label[i] > 1e-5}
    np.save(os.path.join(out_dir, name + ".npy"), cam_dict)
    return cam_dict


def save_cam_pred(out_dir: str, name: str, norm_cam: np.ndarray, alpha: float = 0.26):
    """argmax png with constant bg score `alpha` (contrast_infer.py:92-99)."""
    os.makedirs(out_dir, exist_ok=True)
    bg = np.ones_like(norm_cam[:1]) * alpha
    pred = np.argmax(np.concatenate([bg, norm_cam], axis=0), axis=0).astype(np.uint8)
    write_png(os.path.join(out_dir, name + ".png"), pred)
    return pred
