"""The yardstick's operation counts: the plain reference run on the meta device
under `FlopCounterMode` at a cell's exact shapes (no bucket padding), so a
count does not change with the program that does the work. Only products
count (convolutions and matrix products, forward and backward); elementwise
work and resizes are left out.

`pcm_work` counts K1's least work for one image's views as the kernel table
of PERF.md counts it: 2 N hw^2 (Cf + C) operations (the affinity and the
propagation), and each input and output read or written once.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import contrast_net, losses, train

META = torch.device("meta")


def _meta_params(requires_grad=()) -> dict:
    return {n: torch.empty(s, device=META).requires_grad_(n in requires_grad)
            for n, s, _, _ in contrast_net.param_specs()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def view_hw(h: int, w: int, s: float) -> tuple[int, int]:
    return round(h * s), round(w * s)


@functools.lru_cache(maxsize=None)
def cam_image(h: int, w: int, scales: tuple) -> int:
    """The MSF forward of one h x w image: per scale the view and its mirror
    at their exact size, trunk, heads and PCM."""
    p = _meta_params()

    def run():
        for s in scales:
            x = torch.empty((2, 3, *view_hw(h, w, s)), device=META)
            contrast_net.forward(p, x, raw_cam=True)

    return _count(run)


@functools.lru_cache(maxsize=None)
def train_step(batch: int, crop: int, low_res: int, bg_threshold: float) -> int:
    """One stage-1 step: both views' training forward, the losses and the
    backward to every trained leaf."""
    trained = [n for n, *_ in contrast_net.param_specs()
               if train.is_parameter(n) and train.lr_mult(n) > 0]
    p = _meta_params(set(trained))

    def draw(shape):
        return torch.empty(shape, device=META).uniform_()

    def run():
        img = torch.empty((batch, 3, crop, crop), device=META)
        label21 = torch.ones((batch, 21), device=META)
        out1 = contrast_net.forward(p, img, draw=draw)
        out2 = contrast_net.forward(p, contrast_net.up(img, (low_res, low_res)), draw=draw)
        m = batch * (low_res // 8) ** 2
        loss = losses.stage1_loss(out1, out2, label21, (draw((m,)), draw((m,))),
                                  bg_threshold, low_res)["loss"]
        torch.autograd.grad(loss, [p[n] for n in trained])

    return _count(run)


def pcm_work(h: int, w: int, scales, cf: int = 192, c: int = 21) -> tuple[float, float]:
    """(operations, bytes) of K1 over one image's views at their exact
    stride-8 sizes: a pair (the view and its mirror) per scale."""
    ops = nbytes = 0.0
    for s in scales:
        vh, vw = view_hw(h, w, s)
        hw = -(-vh // 8) * -(-vw // 8)
        ops += 2 * 2 * hw * hw * (cf + c)
        nbytes += 2 * hw * (c + cf + c) * 4
    return ops, nbytes
