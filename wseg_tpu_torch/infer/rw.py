"""Random-walk CAM refinement, stage-2 inference (counterpart of
wseg_tpu/infer/rw.py; reference aff_infer.py:82-141).

Images are grouped by their bucketed size and padded to it with zeros; per
group: the AffinityNet forward, each image's dense affinity matrix, the
batched walk (ops/random_walk.py), the argmax on the device, and a crop
back to each image's own size. Each dispatch is capped at `max_walk_px`
padded pixels, and chunking never changes an output.
"""

from __future__ import annotations

import numpy as np
import torch

from wseg_tpu_torch.models.affinity import clamped_radius
from wseg_tpu_torch.ops.pairs import (
    dense_affinity_matrix,
    dense_affinity_matrix_banded,
    pair_index_tensors,
)
from wseg_tpu_torch.ops.random_walk import random_walk_refine
from wseg_tpu_torch.parallel.mesh import broadcast_module

# Per-dispatch pixel budget of the batched walk, the JAX package's values
# (chosen there for a 16 GB TPU, wseg_tpu/infer/rw.py:20-32): 96 images at
# 384x512 with the sliced pair affinities; 64 with the gather form, whose
# (N, C, D, P) temporary is 14.4 GB in float32 at 96 images. Larger buckets
# get proportionally fewer images per dispatch.
MAX_WALK_PX = 96 * 384 * 512
MAX_WALK_PX_GATHER = 64 * 384 * 512
MATRIX_IMPLS = ("scatter", "banded")


class RandomWalkRefiner:
    """`model`: an AffinityNet (eval mode is set here) on the device the walk
    runs on. `max_walk_px=None` means unset: MAX_WALK_PX_GATHER for a model
    with pair_impl "gather", else MAX_WALK_PX; an explicit value, even one
    equal to MAX_WALK_PX, is kept as given. `matrix_impl`: "scatter" (the
    reference's sparse to_dense) or "banded" (diagonal views), equal
    outputs. `walk_dtype`: None (float32) or torch.bfloat16 for the
    squaring chain. `group`: data-parallel refinement over a process group
    (parallel/mesh.py): every rank's weights become rank 0's; each rank
    then refines its own images (the CLI gives it `shard_indices`' block)."""

    def __init__(self, model: torch.nn.Module, beta: int = 8, logt: int = 6, bucket: int = 64,
                 max_walk_px: int | None = None, matrix_impl: str = "scatter",
                 walk_dtype: torch.dtype | None = None, group=None):
        if matrix_impl not in MATRIX_IMPLS:
            raise ValueError(f"matrix_impl must be one of {MATRIX_IMPLS}, got {matrix_impl!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.beta = beta
        self.logt = logt
        self.bucket = bucket
        if max_walk_px is None:
            max_walk_px = (MAX_WALK_PX_GATHER if getattr(model, "pair_impl", "sliced") == "gather"
                           else MAX_WALK_PX)
        self.max_walk_px = max_walk_px
        self.matrix_impl = matrix_impl
        self.walk_dtype = walk_dtype
        broadcast_module(model, group)

    def padded_size(self, h: int, w: int) -> tuple[int, int]:
        mult = self.bucket or 8
        return -(-h // mult) * mult, -(-w // mult) * mult

    def chunk_size(self, ph: int, pw: int) -> int:
        """Images per dispatch at padded size (ph, pw)."""
        return max(1, self.max_walk_px // (ph * pw))

    @torch.inference_mode()
    def walk_scores(self, imgs: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        """imgs (B, 3, ph, pw), cams (B, 21, ph, pw) on the device, padded to
        one bucket -> the refined (B, 21, ph, pw) float32 scores."""
        ph, pw = imgs.shape[-2:]
        h8, w8 = ph // 8, pw // 8
        aff = self.model(imgs)  # (B, D, P)
        radius = clamped_radius(h8, w8, getattr(self.model, "radius", 5))
        if self.matrix_impl == "banded":
            mat = dense_affinity_matrix_banded(aff, radius, (h8, w8))
        else:
            mat = dense_affinity_matrix(aff, *pair_index_tensors(radius, (h8, w8), aff.device),
                                        h8 * w8)
        del aff
        return random_walk_refine(cams, mat, beta=self.beta, logt=self.logt,
                                  compute_dtype=self.walk_dtype)

    def pad(self, items: list[tuple[np.ndarray, np.ndarray]]) -> tuple[torch.Tensor, torch.Tensor]:
        """[(image (H, W, 3), cam (H, W, 21)), ...] of one bucket -> zero-padded
        (imgs, cams) on the device, NCHW views of channels-last memory. The
        host copies whole rows into (pinned, on CUDA) buffers; the layout
        change happens on the device."""
        ph, pw = self.padded_size(*items[0][0].shape[:2])
        pin = self.device.type == "cuda"
        imgs = torch.empty((len(items), ph, pw, 3), pin_memory=pin)
        cams = torch.empty((len(items), ph, pw, 21), pin_memory=pin)
        for j, (im, cam) in enumerate(items):
            h, w = im.shape[:2]
            if self.padded_size(h, w) != (ph, pw):
                raise ValueError(f"image {j} ({h}x{w}) is not in the {ph}x{pw} bucket")
            for buf, src in ((imgs, im), (cams, cam)):
                a = buf[j].numpy()
                a[:h, :w] = src
                a[h:] = 0
                a[:h, w:] = 0
        return tuple(t.to(self.device, non_blocking=True).permute(0, 3, 1, 2)
                     for t in (imgs, cams))

    def refine_batch(self, items: list[tuple[np.ndarray, np.ndarray]]) -> list[np.ndarray]:
        """items: [(normalised image (H, W, 3), cam (H, W, 21) with the
        background filled), ...]. Returns the argmax pseudo-masks, (H, W)
        uint8 at each image's own size.

        Images are grouped by their own bucketed size, so each one is padded
        exactly as alone and its output equals `refine_one`'s."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (im, _) in enumerate(items):
            groups.setdefault(self.padded_size(*im.shape[:2]), []).append(i)

        out: list[np.ndarray | None] = [None] * len(items)
        for (ph, pw), idxs_all in groups.items():
            bmax = self.chunk_size(ph, pw)
            for s in range(0, len(idxs_all), bmax):
                idxs = idxs_all[s:s + bmax]
                scores = self.walk_scores(*self.pad([items[i] for i in idxs]))
                preds = scores.argmax(dim=1).to(torch.uint8).cpu().numpy()
                for j, i in enumerate(idxs):
                    h, w = items[i][0].shape[:2]
                    out[i] = preds[j, :h, :w]
        return out

    def refine_one(self, img_hwc: np.ndarray, cam_full: np.ndarray) -> np.ndarray:
        """One image: `refine_batch` of a batch of one."""
        return self.refine_batch([(img_hwc, cam_full)])[0]
