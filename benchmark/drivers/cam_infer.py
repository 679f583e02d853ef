"""Stage-1 CAM seeds as `contrast_infer --batch_size B --out_cam D` makes them.

A copy of the CLI's loop (wseg_tpu_torch/cli/contrast_infer.py): the
dataset `VOC12ClsDatasetMSF` over a synthetic VOC root of seed-made JPEGs,
prepared ahead on the CLI's 4 threads in a window of max(4, B) images,
batches of B fed to `CamInferencer.infer_batch` (bucket 64), each image's
{class: CAM} dict written with `save_cam_dict`. The list is cycled: the
window's images overwrite the files of the cycle before.

Correct: after the window, a seed-drawn sample of the images it wrote is
read back and held against the plain reference, which decodes the same
JPEGs and prepares its views itself.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import flops, traffic, weights
from benchmark.reference import cam as ref_cam
from benchmark.reference.precision import reference_precision


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t, c = ctx.cell["traffic"], ctx.config
        self.batch = t["batch"]
        self.scales = tuple(c["infer"]["scales"])
        self.root = ctx.workdir / "VOC2012"
        self.out_dir = ctx.workdir / "out_cam"
        g = traffic.rng(ctx.seed, 0)
        n_batches = t["images"] // self.batch
        self.sizes = [tuple(s) for s in traffic.per_batch(t["sizes"], self.batch, n_batches, g)]
        self.labels = traffic.labels(t["labels"], len(self.sizes), g)
        self.names = [f"2007_{i:06d}" for i in range(len(self.sizes))]
        self.pos = 0  # next position in the endless cycle over the list
        self.window_items: list[int] = []
        self.counted = None

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from wseg_tpu_torch.data.voc12 import VOC12ClsDatasetMSF
        from wseg_tpu_torch.infer.cam import CamInferencer, save_cam_dict
        from wseg_tpu_torch.kernels import pcm_cuda
        from wseg_tpu_torch.models import build_model

        ctx, t = self.ctx, self.ctx.cell["traffic"]
        traffic.write_voc(self.root, ctx.seed, self.names, self.sizes, self.labels,
                          threads=t["prefetch_threads"])
        list_path = ctx.workdir / "infer_list.txt"
        list_path.write_text("".join(n + "\n" for n in self.names))
        model = build_model(ctx.config["model"], device=ctx.device)
        model.load_state_dict(self._weights(), strict=True)  # the reference makes its own again
        self.dataset = VOC12ClsDatasetMSF(str(list_path), str(self.root), scales=self.scales)
        self.inferencer = CamInferencer(model, scales=self.scales,
                                        bucket=ctx.config["infer"]["bucket"])
        self.pool = ThreadPoolExecutor(max_workers=t["prefetch_threads"])
        self.pending = deque()
        self.window = max(4, self.batch)
        for _ in range(self.window):
            self._submit()
        self.pcm = pcm_cuda
        self.save = save_cam_dict
        self.step()  # every batch has the same composition, so one batch warms every shape
        for f in self.pending:  # a full prefetch window at the start, as in steady state
            f.result()
        self.window_items = []

    def _weights(self):
        return weights.contrast(self.ctx.seed, self.ctx.device)

    def _submit(self):
        idx = self.pos % len(self.names)
        self.pos += 1
        self.pending.append(self.pool.submit(self._prepare, idx))

    def _prepare(self, idx):
        with self.ctx.spans.span("host_prep"):
            return idx, self.dataset[idx]

    # -- the window -------------------------------------------------------------
    def begin_window(self):
        self.counted = dict(self.pcm.variant_launches)

    def step(self) -> int:
        spans = self.ctx.spans
        with spans.span("input_wait"):
            chunk = []
            for _ in range(self.batch):
                chunk.append(self.pending.popleft().result())
                self._submit()
        with spans.span("infer"):
            cams = self.inferencer.infer_batch(
                [(views, np.asarray(label), hw) for _, (_, views, label, hw) in chunk])
        with spans.span("write"):
            for (idx, (name, _, label, _)), cam in zip(chunk, cams):
                self.save(str(self.out_dir), name, cam, label)
        self.window_items += [idx for idx, _ in chunk]
        return len(chunk)

    def end_window(self):
        now = self.pcm.variant_launches
        self.counters = {f"pcm_launches.{k}": now[k] - self.counted[k] for k in now}
        self.pool.shutdown(wait=True, cancel_futures=True)

    def work(self) -> dict:
        """The reference's count of the window's work, at the images' exact
        sizes."""
        total = pcm_ops = pcm_bytes = 0.0
        for idx in self.window_items:
            h, w = self.sizes[idx]
            total += flops.cam_image(h, w, self.scales)
            o, b = flops.pcm_work(h, w, self.scales)
            pcm_ops, pcm_bytes = pcm_ops + o, pcm_bytes + b
        return {"flops": total, "pcm_ops": pcm_ops, "pcm_bytes": pcm_bytes}

    # -- correct ------------------------------------------------------------------
    def release(self):
        del self.inferencer, self.dataset
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        """[(name, reading, limit)] over a seed-drawn sample of the window's
        images, every class of their labels:

        - `cam_gap`: the mean over those class maps of the mean |program -
          reference| over the map's pixels, both fused CAMs clipped at 0
          (a pixel the fusion's threshold sets to 0 reads -(min + 1e-5) /
          (max - min + 1e-5) below 0; clipped, the threshold is no step);
        - `wrong_keys`: sampled images whose dict is missing, or holds other
          classes than the labels or maps of another size.

        With `control`, the reference in bfloat16 stands in for the program."""
        from PIL import Image

        limits = self.ctx.cell["check"]["limits"]
        g = traffic.rng(self.ctx.seed, 4)
        sample = g.permutation(sorted(set(self.window_items)))[: self.ctx.cell["check"]["images"]]
        gaps, wrong = [], 0
        params = self._weights()
        low = {k: v.to(torch.bfloat16) for k, v in params.items()} if control else None
        with reference_precision():
            for idx in sample:
                name, label = self.names[idx], self.labels[idx]
                img = np.asarray(Image.open(self.root / "JPEGImages" / f"{name}.jpg")
                                 .convert("RGB"))
                want = ref_cam.msf_cam(params, img, label, self.scales)
                keys = [int(k) for k in np.flatnonzero(label > 1e-5)]
                if control:
                    low_cam = ref_cam.msf_cam(low, img, label, self.scales, torch.bfloat16)
                    got = {k: low_cam[k] for k in keys}
                else:
                    path = self.out_dir / f"{name}.npy"
                    got = np.load(path, allow_pickle=True).item() if os.path.exists(path) else {}
                if sorted(got) != keys or any(got[k].shape != img.shape[:2] for k in keys):
                    wrong += 1
                    continue
                gaps += [float(np.abs(np.maximum(got[k], 0.0) - np.maximum(want[k], 0.0)).mean())
                         for k in keys]
        return [("cam_gap", float(np.mean(gaps)) if gaps else 0.0, limits["cam_gap"]),
                ("wrong_keys", wrong, 0)]
