"""Shared building blocks, NCHW (counterpart of wseg_tpu/models/layers.py).

Stage-1 backbones freeze every BatchNorm (resnet38d.py:207-212 of the
reference), so stage-1 BN is a constant per-channel affine of the running
stats. Stage 3 (DeepLab) trains with batch statistics: `frozen=False`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.parallel.mesh import all_reduce_sum


class BatchNorm2d(nn.Module):
    """BatchNorm with the reference's state_dict keys (`weight`, `bias`,
    `running_mean`, `running_var`).

    frozen=True (the default), or eval mode: `x * scale + (bias - mean *
    scale)` with `scale = weight * rsqrt(var + eps)` from the running stats,
    as layers.py:61-62 of the JAX package.

    frozen=False in train mode: normalise with the batch statistics over
    (N, H, W) and update the running stats, torch's convention
    `new = (1 - momentum) * old + momentum * batch` with the unbiased batch
    variance (layers.py:49-59). This is `F.batch_norm`, chosen by the parity
    test (tests/test_torch_seg_models.py): against the JAX package's E[x^2] -
    E[x]^2 it agrees within 3.7e-7 of the output's max and 9.5e-7 of the
    running-stat update's; where a channel's mean is 2 std, the JAX formula
    is 1.3e-6 from the float64 result and `F.batch_norm` 1.0e-7, and no
    formula written out in torch got closer to JAX than `F.batch_norm` does
    (its summation order differs). `F.batch_norm` refuses one value per
    channel (N * H * W = 1, ASPP's global branch at batch 1); there the JAX
    package's arithmetic runs: the batch variance E[x^2] - E[x]^2 is 0, the
    output is `bias` up to rounding, and the stored variance takes
    var * n / max(n - 1, 1).

    With `group` set (parallel/mesh.py:bind), train mode takes the moments
    over the group's global batch: one differentiable all_reduce of the
    per-channel (sum x, sum x^2, count), then the JAX package's arithmetic
    with the global n (layers.py:49-59 there: var = E[x^2] - E[x]^2, stored
    var * n / max(n - 1, 1)). The input gradient flows through every rank's
    moments, as it does through the one-process batch statistics."""

    def __init__(self, features: int, eps: float = 1e-5, frozen: bool = True,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.frozen = frozen
        self.momentum = momentum
        self.group = None  # a process group: global-batch moments in train mode
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen or not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale[:, None, None] + shift[:, None, None]
        if self.group is not None or x.shape[0] * x.shape[2] * x.shape[3] == 1:
            return self._moments(x)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=True, momentum=self.momentum, eps=self.eps)

    def _moments(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN with the JAX package's arithmetic (layers.py:49-59
        there), over the group's global batch when `group` is set."""
        c = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3)),
                          x.new_full((1,), x.shape[0] * x.shape[2] * x.shape[3])])
        if self.group is not None:
            sums = all_reduce_sum(sums, self.group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = sums[c:2 * c] / n - mean.square()
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var * n / (n - 1).clamp_min(1))
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Dropout(nn.Module):
    """Element-wise dropout (the DeepLab heads' `jnp.where(mask, f / keep,
    0)`, deeplab.py:150-153); the identity in eval mode. With `generator` set
    (the training steps set it), the keep mask is drawn from that generator,
    so a run is reproducible from its seed; without, from torch's global
    stream. `rate = 0` keeps everything. With `shard = (rank, world)` (set
    by parallel/mesh.py:bind) the mask is drawn at the global batch's shape,
    world times this rank's rows, and the rank keeps its rows: every rank's
    generator then advances as the one process's does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        self.shard: tuple[int, int] | None = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        shape = self.mask_shape(x)
        if self.shard is None:
            u = torch.rand(shape, generator=self.generator, device=x.device)
        else:
            rank, world = self.shard
            n = shape[0]
            u = torch.rand((n * world, *shape[1:]), generator=self.generator,
                           device=x.device)[rank * n:(rank + 1) * n]
        return x * ((u >= self.rate).to(x.dtype) / (1.0 - self.rate))


class Dropout2d(Dropout):
    """Channel dropout (torch.nn.Dropout2d, resnet38d.py:64,68): one keep
    draw per (sample, channel)."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0], x.shape[1], 1, 1)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
         padding: int | None = None, bias: bool = False) -> nn.Conv2d:
    """Conv2d with the JAX package's padding rule: symmetric, by default
    `dilation * (kernel - 1) // 2` ('same' for the dilated kernel); bias-free
    unless asked."""
    if padding is None:
        padding = dilation * (kernel - 1) // 2
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     dilation=dilation, bias=bias)


def he_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """He-normal (fan_in) init of an OIHW kernel from `generator`, in place
    (call under torch.no_grad() for a parameter)."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    return w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator,
                    gain: float = 1.0) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ with gain, drawn from `generator`."""
    rf = w.shape[2] * w.shape[3]
    a = gain * math.sqrt(6.0 / (w.shape[1] * rf + w.shape[0] * rf))
    return w.uniform_(-a, a, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator, xavier_gain: dict) -> None:
    """The stage-1 and stage-2 nets' init, drawn from `generator` in module
    order: Xavier-uniform kernels for the convs in `xavier_gain` (module ->
    gain), He-normal for every other conv, identity BN."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            if m in xavier_gain:
                xavier_uniform_(m.weight, generator, xavier_gain[m])
            else:
                he_normal_(m.weight, generator)
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            m.running_mean.fill_(0.0)
            m.running_var.fill_(1.0)
