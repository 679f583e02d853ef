"""Stage-1 training as `contrast_train` steps: `make_train_step` on the
contrast net with `PolySGD` over `param_groups`, the configuration's
hyperparameters, and a dropout and NCE-key generator on the card.

Batches are device-resident: a pool of seed-made photo-like crops (NHWC,
fed as the CLI feeds them, an NCHW view) and VOC-like labels, cycled. The
first three steps are set-up; they are also what `correct` holds against
the reference: each step's loss, every trained leaf's first gradient (its
momentum buffer after step 1 less the weight decay) and its change over the
three steps. The weights are drawn once in set-up; the check, after the
window, draws them again from the seed. The window then steps on from the
fourth batch, one step at a time, each ended by a synchronize.
"""

from __future__ import annotations

import torch

from benchmark import compare, flops, traffic, weights
from benchmark.reference import train as ref_train
from benchmark.reference.precision import reference_precision

CHECKED_STEPS = 3


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell["traffic"]
        self.cfg = ctx.config["train"]
        self.steps_done = 0
        self.window_steps = 0

    def _weights(self):
        return weights.contrast(self.ctx.seed, self.ctx.device)

    def _keys(self):
        return torch.Generator(device=self.ctx.device).manual_seed(traffic.torch_seed(self.ctx.seed, 3))

    def _pool(self):
        t, dev = self.t, self.ctx.device
        n = t["pool_batches"] * t["batch"]
        gen = torch.Generator(device=dev).manual_seed(traffic.torch_seed(self.ctx.seed, 5))
        imgs = traffic.crops(gen, n, t["crop"], dev).view(t["pool_batches"], t["batch"],
                                                          t["crop"], t["crop"], 3)
        labels = traffic.labels(t["labels"], n, traffic.rng(self.ctx.seed, 0))
        labels = torch.from_numpy(labels).to(dev).view(t["pool_batches"], t["batch"], -1)
        return imgs, labels

    def setup(self):
        from wseg_tpu_torch.models import build_model
        from wseg_tpu_torch.train.contrast import make_train_step
        from wseg_tpu_torch.train.optim import PolySGD, param_groups

        ctx, cfg = self.ctx, self.cfg
        self.model = build_model(ctx.config["model"], device=ctx.device)
        p0 = self._weights()
        self.model.load_state_dict(p0, strict=True)
        self.optimizer = PolySGD(param_groups(self.model), cfg["lr"], cfg["weight_decay"],
                                 cfg["max_step"], power=cfg["poly_power"],
                                 momentum=cfg["momentum"])
        self.step_fn = make_train_step(self.model, self.optimizer, cfg["bg_threshold"],
                                       low_res=cfg["low_res"], generator=self._keys())
        self.imgs, self.labels = self._pool()
        self.losses = []
        for i in range(CHECKED_STEPS):
            self.step()
            self.losses.append(self.metrics["loss"])
            if i == 0:
                self.cls_er = [self.metrics["loss_cls"], self.metrics["loss_er"]]
                self.grad = self._first_grads(p0)
        self.change = self._changes(p0)

    def _first_grads(self, p0) -> dict:
        """{leaf: ||momentum buffer - wd * p0||} after step 1: the buffer holds
        g + wd * p0 (PolySGD, from zero)."""
        wd = self.cfg["weight_decay"]
        out = {}
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p, {})
            if "momentum_buf" in state:
                out[name] = torch.linalg.vector_norm(state["momentum_buf"] - wd * p0[name])
        return out

    def _changes(self, p0) -> dict:
        return {name: torch.linalg.vector_norm(p.detach() - p0[name])
                for name, p in self.model.named_parameters()}

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
        t, cfg = self.t, self.cfg
        return {"flops": self.window_steps * flops.train_step(t["batch"], t["crop"],
                                                              cfg["low_res"],
                                                              cfg["bg_threshold"])}

    def release(self):
        del self.step_fn, self.optimizer, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        """[(name, reading, limit)]:

        - `cls_er_gap`: the larger relative gap of step 1's classification
          and equivariance terms, which no flipped selection moves (the
          other terms' top-k, argmax and rank bands: PERF.md);
        - `loss_gap`: the largest relative gap of a checked step's loss;
        - `grad_gap`: the largest gap of a trained leaf's first gradient
          norm, against the reference's norm of that leaf or of the median
          leaf, whichever is larger;
        - `change_gap`: that gap of each leaf's change over the three steps,
          at the median leaf (at the worst leaf it swings with the later
          steps: PERF.md);
        - `frozen_moved`: the largest change of a leaf the reference keeps
          fixed, held at 0.

        Leaves whose reference gradient is under a thousandth of the median
        leaf's are left out of the gaps. With `control`, the reference with
        TF32 on stands in for the program."""
        limits = self.ctx.cell["check"]["limits"]
        batches = [(self.imgs[i].permute(0, 3, 1, 2), self.labels[i])
                   for i in range(CHECKED_STEPS)]
        p0 = self._weights()
        want = _reference(p0, batches, self.cfg, self._keys(), tf32=False)
        if control:
            low = _reference(p0, batches, self.cfg, self._keys(), tf32=True)
            losses, grad = low["loss"], low["grad"]
            cls_er = [low["cls"][0], low["er"][0]]
            change = dict(low["change"])
            change.update({k: torch.zeros(()) for k in self.change if k not in change})
        else:
            losses, cls_er, grad, change = self.losses, self.cls_er, self.grad, self.change
        keep = compare.moved(want["grad"])
        frozen = [k for k in change if k not in want["change"]]
        return [
            ("cls_er_gap", compare.rel_gap(cls_er, [want["cls"][0], want["er"][0]]),
             limits["cls_er_gap"]),
            ("loss_gap", compare.rel_gap(losses, want["loss"]), limits["loss_gap"]),
            ("grad_gap", compare.leaf_gap(grad, want["grad"], keep), limits["grad_gap"]),
            ("change_gap", compare.leaf_gap(change, want["change"], keep, at="median"),
             limits["change_gap"]),
            ("frozen_moved", max([float(change[k]) for k in frozen], default=0.0), 0.0),
        ]


def _reference(p0, batches, cfg, keys, tf32: bool) -> dict:
    with reference_precision(tf32):
        return ref_train.steps(p0, batches, cfg, keys)
