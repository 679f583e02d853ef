"""The operation count of the stage-3 step, as `flops.py` counts stage 1's: the
plain reference (benchmark/reference/deeplab.py) run on the meta device under
`FlopCounterMode` at the cell's exact shapes, so the count does not change
with the program that does the work. Only products count (convolutions,
forward and backward to every trained leaf); BN, the loss, dropout and the
upsample are left out."""

from __future__ import annotations

import functools

import torch

from benchmark.flops import META, _count
from benchmark.reference import deeplab


@functools.lru_cache(maxsize=None)
def train_step(batch: int, crop: int) -> int:
    """One step: the training forward of `batch` crops of `crop` x `crop`,
    the loss and the backward to every trained leaf."""
    specs = deeplab.param_specs()
    trained = [n for n, *_ in specs if deeplab.lr_mult(n) > 0]
    p = {n: torch.empty(s, device=META).requires_grad_(n in trained) for n, s, _, _ in specs}

    def draw(shape):
        return torch.empty(shape, device=META).uniform_()

    def run():
        img = torch.empty((batch, 3, crop, crop), device=META)
        label = torch.zeros((batch, crop, crop), dtype=torch.int32, device=META)
        loss = deeplab.loss(deeplab.forward(p, img, draw, {}), label)
        torch.autograd.grad(loss, [p[n] for n in trained])

    return _count(run)
