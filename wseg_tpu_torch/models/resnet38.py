"""Dilated WideResNet-38 (A1) backbone, output stride 8, NCHW.

Counterpart of wseg_tpu/models/resnet38.py (reference network/resnet38d.py):
pre-activation residual blocks, stride 8 via dilation 2 (b5*) and 4 (b6/b7),
and the conv3/conv4/conv5/conv6 taps. BatchNorms are frozen by default, as
the reference forces for stages 1-2 (resnet38d.py:207-212). Its stage-3
training scripts never call `net.train()`, so there the same trunk runs its BNs in
batch-statistics mode with the module-constant momentum 3e-4
(resnet38d.py:8): `bn_frozen=False` (seg/backbones.py:SegResNet38). Module
names are the reference's, so `state_dict()` keys equal its keys.

`valid_hw` (N, 2) marks per-sample valid regions when a batch is zero-padded
to a common (bucketed) shape: the pad halo is re-zeroed after every bn+relu,
so each conv sees exactly the zeros that exact-shape padding would supply and
valid outputs equal the exact-shape forward.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn

from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout2d, conv

# (mean, std) of the reference's input normalization (resnet38d.py:104-118)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(img_uint8) -> np.ndarray:
    """HWC uint8 -> normalized HWC float32 (host side)."""
    arr = np.asarray(img_uint8, dtype=np.float32) / 255.0
    return (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
        IMAGENET_STD, np.float32
    )


def apply_mask(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Re-zero the pad halo (no-op without a mask)."""
    return x if mask is None else x * mask


BN_MOM = 3e-4  # resnet38d.py:8, the momentum of every trunk BN


class ResBlock(nn.Module):
    """Pre-activation basic block: bn-relu -> [1x1 shortcut if reshaping]
    + conv3x3(stride, first_dilation) - bn-relu - conv3x3(dilation)."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 stride: int = 1, first_dilation: int | None = None,
                 dilation: int = 1, bn_frozen: bool = True):
        super().__init__()
        self.same_shape = in_channels == out_channels and stride == 1
        fd = dilation if first_dilation is None else first_dilation
        bn = partial(BatchNorm2d, frozen=bn_frozen, momentum=BN_MOM)
        self.bn_branch2a = bn(in_channels)
        if not self.same_shape:
            self.conv_branch1 = conv(in_channels, out_channels, 1, stride)
        self.conv_branch2a = conv(in_channels, mid_channels, 3, stride,
                                  dilation=fd, padding=fd)
        self.bn_branch2b1 = bn(mid_channels)
        self.conv_branch2b1 = conv(mid_channels, out_channels, 3,
                                   dilation=dilation, padding=dilation)

    def forward(self, x, get_x_bn_relu: bool = False, mask_in=None, mask_out=None):
        """mask_in / mask_out: optional (N, 1, H, W) valid-region masks at the
        input / post-stride resolution."""
        branch2 = apply_mask(torch.relu(self.bn_branch2a(x)), mask_in)
        x_bn_relu = branch2
        branch1 = x if self.same_shape else self.conv_branch1(branch2)
        branch2 = self.conv_branch2a(branch2)
        branch2 = apply_mask(torch.relu(self.bn_branch2b1(branch2)), mask_out)
        branch2 = self.conv_branch2b1(branch2)
        out = branch1 + branch2
        return (out, x_bn_relu) if get_x_bn_relu else out


class ResBlockBot(nn.Module):
    """Pre-activation bottleneck with channel dropout (resnet38d.py:54-102).
    The 1x1 shortcut is unconditional."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, dropout: float = 0.0, bn_frozen: bool = True):
        super().__init__()
        bn = partial(BatchNorm2d, frozen=bn_frozen, momentum=BN_MOM)
        self.bn_branch2a = bn(in_channels)
        self.conv_branch1 = conv(in_channels, out_channels, 1, stride)
        self.conv_branch2a = conv(in_channels, out_channels // 4, 1, stride)
        self.bn_branch2b1 = bn(out_channels // 4)
        self.dropout_2b1 = Dropout2d(dropout)
        self.conv_branch2b1 = conv(out_channels // 4, out_channels // 2, 3,
                                   dilation=dilation, padding=dilation)
        self.bn_branch2b2 = bn(out_channels // 2)
        self.dropout_2b2 = Dropout2d(dropout)
        self.conv_branch2b2 = conv(out_channels // 2, out_channels, 1)

    def forward(self, x, get_x_bn_relu: bool = False, mask_in=None, mask_out=None):
        branch2 = apply_mask(torch.relu(self.bn_branch2a(x)), mask_in)
        x_bn_relu = branch2
        branch1 = self.conv_branch1(branch2)
        branch2 = self.conv_branch2a(branch2)
        branch2 = apply_mask(torch.relu(self.bn_branch2b1(branch2)), mask_out)
        branch2 = self.conv_branch2b1(self.dropout_2b1(branch2))
        branch2 = apply_mask(torch.relu(self.bn_branch2b2(branch2)), mask_out)
        branch2 = self.conv_branch2b2(self.dropout_2b2(branch2))
        out = branch1 + branch2
        return (out, x_bn_relu) if get_x_bn_relu else out


def valid_mask(valid_hw: torch.Tensor, hw: tuple[int, int], stride: int) -> torch.Tensor:
    """(N, 1, H, W) float mask of each sample's valid region at `stride`.

    valid_hw: (N, 2) integer input-resolution valid sizes; hw: padded spatial
    dims at this stride. The valid extent at stride s is ceil(v / s), the
    output size chain of the stride-2 convs (k3, p1: ceil(H / 2))."""
    h, w = hw
    vh = (valid_hw[:, 0] + stride - 1) // stride  # (N,)
    vw = (valid_hw[:, 1] + stride - 1) // stride
    dev = valid_hw.device
    rows = torch.arange(h, device=dev)[None, :, None] < vh[:, None, None]  # (N, H, 1)
    cols = torch.arange(w, device=dev)[None, None, :] < vw[:, None, None]  # (N, 1, W)
    return (rows & cols)[:, None].float()


class ResNet38(nn.Module):
    """Backbone returning the {conv3, conv4, conv5, conv6} tap dict
    (resnet38d.py:160-189)."""

    def __init__(self, bn_frozen: bool = True):
        super().__init__()
        rb = partial(ResBlock, bn_frozen=bn_frozen)
        rbb = partial(ResBlockBot, bn_frozen=bn_frozen)
        self.conv1a = conv(3, 64, 3, padding=1)
        self.b2 = rb(64, 128, 128, stride=2)
        self.b2_1 = rb(128, 128, 128)
        self.b2_2 = rb(128, 128, 128)
        self.b3 = rb(128, 256, 256, stride=2)
        self.b3_1 = rb(256, 256, 256)
        self.b3_2 = rb(256, 256, 256)
        self.b4 = rb(256, 512, 512, stride=2)
        self.b4_1 = rb(512, 512, 512)
        self.b4_2 = rb(512, 512, 512)
        self.b4_3 = rb(512, 512, 512)
        self.b4_4 = rb(512, 512, 512)
        self.b4_5 = rb(512, 512, 512)
        self.b5 = rb(512, 512, 1024, stride=1, first_dilation=1, dilation=2)
        self.b5_1 = rb(1024, 512, 1024, dilation=2)
        self.b5_2 = rb(1024, 512, 1024, dilation=2)
        self.b6 = rbb(1024, 2048, dilation=4, dropout=0.3)
        self.b7 = rbb(2048, 4096, dilation=4, dropout=0.5)
        self.bn7 = BatchNorm2d(4096, frozen=bn_frozen, momentum=BN_MOM)

    def forward(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        h0, w0 = x.shape[-2:]

        def mask(stride: int):
            if valid_hw is None:
                return None
            hw = (-(-h0 // stride), -(-w0 // stride))
            return valid_mask(valid_hw, hw, stride).to(x.dtype)

        m1, m2, m4, m8 = mask(1), mask(2), mask(4), mask(8)

        x = self.conv1a(x)
        x = self.b2(x, mask_in=m1, mask_out=m2)
        x = self.b2_1(x, mask_in=m2, mask_out=m2)
        x = self.b2_2(x, mask_in=m2, mask_out=m2)
        x = self.b3(x, mask_in=m2, mask_out=m4)
        x = self.b3_1(x, mask_in=m4, mask_out=m4)
        x = self.b3_2(x, mask_in=m4, mask_out=m4)
        x, conv3 = self.b4(x, get_x_bn_relu=True, mask_in=m4, mask_out=m8)
        for blk in (self.b4_1, self.b4_2, self.b4_3, self.b4_4, self.b4_5):
            x = blk(x, mask_in=m8, mask_out=m8)
        x, conv4 = self.b5(x, get_x_bn_relu=True, mask_in=m8, mask_out=m8)
        x = self.b5_1(x, mask_in=m8, mask_out=m8)
        x = self.b5_2(x, mask_in=m8, mask_out=m8)
        x, conv5 = self.b6(x, get_x_bn_relu=True, mask_in=m8, mask_out=m8)
        x = self.b7(x, mask_in=m8, mask_out=m8)
        conv6 = apply_mask(torch.relu(self.bn7(x)), m8)
        return {"conv3": conv3, "conv4": conv4, "conv5": conv5, "conv6": conv6}
