"""Shared building blocks, NCHW (counterpart of wseg_tpu/models/layers.py).

Stage-1 backbones freeze every BatchNorm (resnet38d.py:207-212 of the
reference), so stage-1 BN is a constant per-channel affine of the running
stats. The batch-statistics mode belongs to stage 3 and is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class BatchNorm2d(nn.Module):
    """Frozen BatchNorm with the reference's state_dict keys (`weight`,
    `bias`, `running_mean`, `running_var`): `x * scale + (bias - mean *
    scale)` with `scale = weight * rsqrt(var + eps)`, as layers.py:61-62 of
    the JAX package."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Dropout2d(nn.Module):
    """Channel dropout (torch.nn.Dropout2d, resnet38d.py:64,68); the identity
    in eval mode. With `generator` set (the training step sets it), the
    per-(sample, channel) keep mask is drawn from that generator, so a run is
    reproducible from its seed; without, from torch's global stream."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=self.generator,
                       device=x.device)
        return x * ((u >= self.rate).to(x.dtype) / (1.0 - self.rate))


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
         padding: int | None = None) -> nn.Conv2d:
    """Bias-free Conv2d with the JAX package's padding rule: symmetric, by
    default `dilation * (kernel - 1) // 2` ('same' for the dilated kernel)."""
    if padding is None:
        padding = dilation * (kernel - 1) // 2
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


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
