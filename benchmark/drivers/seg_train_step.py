"""Stage-3 training as `seg_train` steps: the net, the optimizer, the dropout
generator, the step and the cuDNN mode from `build_seg_trainer` on the
configuration's preset, as the CLI builds them.

Batches are device-resident: a pool of seed-made samples, each a VOC-sized
image (a size of the traffic's mix) scaled by a factor drawn from the
preset's range and cropped to the crop size as `seg/dataset.py`'s
`random_scale` and `random_crop` do. Where the scaled image is smaller
than the crop, the crop is padded, zero in the image and 255 in the label.
Inside the image the label is background with an elliptic blob for each
class of a row of real image labels. Images are NHWC, fed as the CLI feeds
them (an NCHW view), labels int32.

The first three steps are set-up; they are also what `correct` holds
against the reference: each step's loss, every trained leaf's first
gradient (its momentum buffer after step 1, less the weight decay where
its group decays) and its change over the three steps, and each BN running
statistic's change. The weights are drawn once in set-up; the check, after
the window, draws them again from the seed. The window then steps on from
the fourth batch, one step at a time, each ended by a synchronize.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, seg_flops, traffic, weights
from benchmark.reference import deeplab
from benchmark.reference.precision import reference_precision

CHECKED_STEPS = 3


def valid_boxes(sizes, scale, crop: int, g: np.random.Generator) -> list:
    """(top, left, height, width) of each image inside its crop: the image
    (h, w) scaled by r ~ U(scale) to (round(h r), round(w r)), then cropped to
    `crop` x `crop`; a side shorter than the crop lands at a random offset."""
    boxes = []
    for h, w in sizes:
        r = g.uniform(*scale)
        sh, sw = min(round(h * r), crop), min(round(w * r), crop)
        boxes.append((int(g.integers(crop - sh + 1)), int(g.integers(crop - sw + 1)), sh, sw))
    return boxes


def masks(boxes, label_rows, crop: int, g: np.random.Generator) -> np.ndarray:
    """(n, crop, crop) int32 labels: 255 outside each box; inside, background
    (0) with one ellipse per class of the sample's row (class c labelled
    c + 1), its centre in the box and its radii 15-45% of the box's sides,
    later classes drawn over earlier ones."""
    yy, xx = np.mgrid[:crop, :crop].astype(np.float32)
    out = np.full((len(boxes), crop, crop), 255, np.int32)
    for i, ((top, left, h, w), row) in enumerate(zip(boxes, label_rows)):
        out[i, top:top + h, left:left + w] = 0
        inside = np.zeros((crop, crop), bool)
        inside[top:top + h, left:left + w] = True
        for c in np.flatnonzero(row):
            cy, cx = top + g.uniform(0, h), left + g.uniform(0, w)
            ry, rx = g.uniform(0.15, 0.45) * h, g.uniform(0.15, 0.45) * w
            out[i][inside & (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)] = c + 1
    return out


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell["traffic"]
        self.cfg = ctx.config["train"]
        self.steps_done = 0
        self.window_steps = 0

    def _weights(self):
        gen = torch.Generator(device=self.ctx.device).manual_seed(
            traffic.torch_seed(self.ctx.seed, 2))
        return weights.make(deeplab.param_specs(), gen, self.ctx.device)

    def _seed(self) -> int:
        """The seed the program's init and dropout generator take."""
        return traffic.torch_seed(self.ctx.seed, 3)

    def _keys(self):
        return torch.Generator(device=self.ctx.device).manual_seed(self._seed())

    def _pool(self):
        t, dev = self.t, self.ctx.device
        n, crop = t["pool_batches"] * t["batch"], t["crop"]
        g = traffic.rng(self.ctx.seed, 6)
        sizes = traffic.per_batch([(tuple(s), share) for s, share in t["sizes"]], t["batch"],
                                  t["pool_batches"], g)
        boxes = valid_boxes(sizes, t["scale"], crop, g)
        rows = traffic.labels(t["labels"], n, traffic.rng(self.ctx.seed, 0))
        labels = torch.from_numpy(masks(boxes, rows, crop, g)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(traffic.torch_seed(self.ctx.seed, 5))
        imgs = traffic.crops(gen, n, crop, dev)
        for i, (top, left, h, w) in enumerate(boxes):
            keep = torch.zeros((crop, crop, 1), device=dev)
            keep[top:top + h, left:left + w] = 1.0
            imgs[i] *= keep
        shape = (t["pool_batches"], t["batch"])
        return imgs.view(*shape, crop, crop, 3), labels.view(*shape, crop, crop)

    def setup(self):
        from wseg_tpu_torch.seg.config import EXPERIMENTS
        from wseg_tpu_torch.train.seg import build_seg_trainer

        ctx = self.ctx
        trainer = build_seg_trainer(EXPERIMENTS[ctx.config["preset"]], ctx.device, self._seed())
        self.model, self.optimizer, self.step_fn = trainer.model, trainer.optimizer, trainer.step
        p0 = self._weights()
        self.model.load_state_dict(p0, strict=True)
        self.imgs, self.labels = self._pool()
        self.losses = []
        for i in range(CHECKED_STEPS):
            t0 = time.perf_counter()
            self.step()
            if i == 0:
                self.first_step_s = time.perf_counter() - t0
                self.grad = self._first_grads(p0)
            self.losses.append(self.metrics["loss"])
        self.change = self._changes(p0, self.model.named_parameters())
        self.running = self._changes(p0, self.model.named_buffers())

    def _first_grads(self, p0) -> dict:
        """{leaf: ||momentum buffer - wd * p0||} after step 1 (wd 0 where the
        leaf's group does not decay): the buffer holds g + wd * p0 (PolySGD,
        from zero)."""
        wd = {id(p): self.optimizer.weight_decay if group["use_wd"] else 0.0
              for group in self.optimizer.param_groups for p in group["params"]}
        out = {}
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p, {})
            if "momentum_buf" in state:
                out[name] = torch.linalg.vector_norm(state["momentum_buf"] - wd[id(p)] * p0[name])
        return out

    @staticmethod
    def _changes(p0, named) -> dict:
        return {name: torch.linalg.vector_norm(v.detach() - p0[name]) for name, v in named}

    def begin_window(self):
        self.window_steps = 0

    def step(self) -> int:
        i = self.steps_done % self.t["pool_batches"]
        with self.ctx.spans.span("step"):
            metrics = self.step_fn(self.imgs[i].permute(0, 3, 1, 2), self.labels[i])
        with self.ctx.spans.span("sync"):
            if self.ctx.device.type == "cuda":
                torch.cuda.synchronize(self.ctx.device)
        self.metrics = metrics
        self.steps_done += 1
        self.window_steps += 1
        return self.t["batch"]

    def end_window(self):
        self.counters = {}

    def work(self) -> dict:
        return {"flops": self.window_steps * seg_flops.train_step(self.t["batch"],
                                                                  self.t["crop"])}

    def release(self):
        del self.step_fn, self.optimizer, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        """[(name, reading, limit)]:

        - `loss1_gap`: the relative gap of step 1's loss, which no argmax or
          earlier update moves;
        - `loss_gap`: the largest relative gap of a checked step's loss;
        - `grad_gap`: the largest gap of a trained leaf's first gradient
          norm, against the reference's norm of that leaf or of the median
          leaf, whichever is larger;
        - `change_gap`: that gap of each leaf's change over the three steps,
          at the median leaf;
        - `running_gap`: that gap of each BN running statistic's change over
          the three steps, at the worst statistic;
        - `frozen_moved`: the largest change of a leaf the reference keeps
          fixed (BN affine), held at 0.

        Leaves whose reference gradient is under a thousandth of the median
        leaf's are left out of the gradient and change gaps. With `control`,
        the reference with TF32 on stands in for the program."""
        limits = self.ctx.cell["check"]["limits"]
        batches = [(self.imgs[i].permute(0, 3, 1, 2), self.labels[i])
                   for i in range(CHECKED_STEPS)]
        p0 = self._weights()
        want = _reference(p0, batches, self.cfg, self._keys(), tf32=False)
        if control:
            low = _reference(p0, batches, self.cfg, self._keys(), tf32=True)
            losses, grad, running = low["loss"], low["grad"], low["running"]
            change = dict(low["change"])
            change.update({k: torch.zeros(()) for k in self.change if k not in change})
        else:
            losses, grad, change, running = self.losses, self.grad, self.change, self.running
        keep = compare.moved(want["grad"])
        frozen = [k for k in change if k not in want["change"]]
        return [
            ("loss1_gap", compare.rel_gap(losses[:1], want["loss"][:1]), limits["loss1_gap"]),
            ("loss_gap", compare.rel_gap(losses, want["loss"]), limits["loss_gap"]),
            ("grad_gap", compare.leaf_gap(grad, want["grad"], keep), limits["grad_gap"]),
            ("change_gap", compare.leaf_gap(change, want["change"], keep, at="median"),
             limits["change_gap"]),
            ("running_gap", compare.leaf_gap(running, want["running"], list(want["running"])),
             limits["running_gap"]),
            ("frozen_moved", max([float(change[k]) for k in frozen], default=0.0), 0.0),
        ]


def _reference(p0, batches, cfg, keys, tf32: bool) -> dict:
    """The reference's losses, and the norms of its first gradients ("grad"),
    of its trained leaves' changes ("change") and of its running
    statistics' changes ("running")."""
    with reference_precision(tf32):
        r = deeplab.steps(p0, batches, cfg, keys)
    with torch.no_grad():
        change = {k: torch.linalg.vector_norm(r["params"][k] - p0[k]) for k in r["grad"]}
        running = {k: torch.linalg.vector_norm(v - p0[k]) for k, v in r["params"].items()
                   if k.endswith(("running_mean", "running_var"))}
        grad = {k: torch.linalg.vector_norm(g) for k, g in r["grad"].items()}
    return {"loss": r["loss"], "grad": grad, "change": change, "running": running}
