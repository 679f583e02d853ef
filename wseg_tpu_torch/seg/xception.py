"""The modified aligned Xception-65 backbone, NCHW (counterpart of
wseg_tpu/seg/xception.py; reference segmentation/lib/net/backbone/
xception.py, registered there but unused by its experiments).

The entry convs conv1 / conv2, 20 separable blocks whose strides follow the
output stride (os 8: (2, 1, 1) for blocks 2, 3 and 20; os 16: (2, 2, 1)),
dilation 16 / os in the middle and exit flows, and the exit separable convs
conv3-5 to 2048 channels. Returns [l1, l2, exit]: l1 and l2 are block 2's
and block 3's pre-stride taps (the reference's hook_layer), so they sit at
strides 4 and 8 for both output strides. Module names are the reference's
(`block{i}.sepconv{1,2,3}.{depthwise,bn1,pointwise,bn2}`, `block{i}.skip`,
`block{i}.skipbn`), so `state_dict()` keys equal its keys. Every BN trains
with batch statistics.

`valid_hw` (N, 2) marks per-sample valid regions when a batch is zero-padded
to a common (bucketed) shape: each separable conv masks its input right
before the depthwise conv, the only op that reads neighbours, and the taps
are masked, so valid outputs equal the exact-shape forward.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from wseg_tpu_torch.models.layers import BatchNorm2d, conv
from wseg_tpu_torch.models.resnet38 import apply_mask, valid_mask
from wseg_tpu_torch.utils.registry import BACKBONES


class SeparableConv(nn.Module):
    """A depthwise k x k conv (groups = in_ch), BN, a pointwise 1x1 conv,
    BN; relu first (`activate_first`) or after each BN (xception.py:25-58 of
    the JAX package)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, activate_first: bool = True, bn_mom: float = 0.1):
        super().__init__()
        bn = partial(BatchNorm2d, frozen=False, momentum=bn_mom)
        self.activate_first = activate_first
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel, stride,
                                   padding=dilation * (kernel - 1) // 2, dilation=dilation,
                                   groups=in_ch, bias=False)
        self.bn1 = bn(in_ch)
        self.pointwise = conv(in_ch, out_ch, 1)
        self.bn2 = bn(out_ch)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """mask: the valid-region mask at the input resolution, applied right
        before the depthwise conv (the 1x1 pointwise keeps the halo's values
        in the halo)."""
        if self.activate_first:
            x = torch.relu(x)
        x = self.bn1(self.depthwise(apply_mask(x, mask)))
        if not self.activate_first:
            x = torch.relu(x)
        x = self.bn2(self.pointwise(x))
        if not self.activate_first:
            x = torch.relu(x)
        return x


class XBlock(nn.Module):
    """Three separable convs (the stride on the third) beside a 1x1 `skip`
    conv + `skipbn` when the block reshapes; returns (output, the masked
    pre-stride tap after sepconv2) (xception.py:61-90 of the JAX package)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, atrous=1,
                 grow_first: bool = True, bn_mom: float = 0.1):
        super().__init__()
        at = tuple(atrous) if isinstance(atrous, (tuple, list)) else (atrous,) * 3
        if out_ch != in_ch or stride != 1:
            self.skip = conv(in_ch, out_ch, 1, stride)
            self.skipbn = BatchNorm2d(out_ch, frozen=False, momentum=bn_mom)
        else:
            self.skip = None
        filters = out_ch if grow_first else in_ch
        sep = partial(SeparableConv, bn_mom=bn_mom)
        self.sepconv1 = sep(in_ch, filters, dilation=at[0])
        self.sepconv2 = sep(filters, out_ch, dilation=at[1])
        self.sepconv3 = sep(out_ch, out_ch, stride=stride, dilation=at[2])

    def forward(self, x: torch.Tensor, mask_in: torch.Tensor | None = None):
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        h = self.sepconv2(self.sepconv1(x, mask_in), mask_in)
        # the low-level tap (the reference's hook_layer), masked so the
        # head's 3x3 convs read exact zeros in the halo
        hook = apply_mask(h, mask_in)
        return self.sepconv3(h, mask_in) + skip, hook


class Xception(nn.Module):
    OUTPUT_DIM = 2048

    def __init__(self, os: int = 8, bn_mom: float = 0.1):
        super().__init__()
        if os not in (8, 16):
            raise ValueError(f"Xception: output stride {os} (8 or 16)")
        self.os = os
        self.stride_list = (2, 1, 1) if os == 8 else (2, 2, 1)
        # stride of each returned tap [l1, l2, exit]: the block taps are
        # pre-stride, so l1 / l2 sit at the block input strides
        self.feature_strides = (4, 8, os)
        self.feature_dims = (256, 728, self.OUTPUT_DIM)
        rate = 16 // os
        bn = partial(BatchNorm2d, frozen=False, momentum=bn_mom)
        blk = partial(XBlock, bn_mom=bn_mom)
        sl = self.stride_list
        self.conv1 = conv(3, 32, 3, 2, padding=1)
        self.bn1 = bn(32)
        self.conv2 = conv(32, 64, 3, 1, padding=1)
        self.bn2 = bn(64)
        self.block1 = blk(64, 128, 2)
        self.block2 = blk(128, 256, sl[0])
        self.block3 = blk(256, 728, sl[1])
        for i in range(4, 20):
            setattr(self, f"block{i}", blk(728, 728, 1, atrous=rate))
        self.block20 = blk(728, 1024, sl[2], atrous=rate, grow_first=False)
        sep = partial(SeparableConv, dilation=rate, activate_first=False, bn_mom=bn_mom)
        self.conv3 = sep(1024, 1536)
        self.conv4 = sep(1536, 1536)
        self.conv5 = sep(1536, 2048)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        h0, w0 = x.shape[-2:]

        def mask(stride: int):
            if valid_hw is None:
                return None
            return valid_mask(valid_hw, (-(-h0 // stride), -(-w0 // stride)),
                              stride).to(x.dtype)

        sl = self.stride_list
        s = (2, 4, 4 * sl[0], 4 * sl[0] * sl[1])
        s3 = s[3] * sl[2]
        x = apply_mask(torch.relu(self.bn1(self.conv1(x))), mask(2))
        x = torch.relu(self.bn2(self.conv2(x)))
        # block outputs keep the halo's values in the residual sum: every
        # consumer masks its own input
        x, _ = self.block1(x, mask(s[0]))
        x, l1 = self.block2(x, mask(s[1]))
        x, l2 = self.block3(x, mask(s[2]))
        m3 = mask(s[3])
        for i in range(4, 21):
            x, _ = getattr(self, f"block{i}")(x, m3)
        m_exit = mask(s3)
        x = self.conv5(self.conv4(self.conv3(x, m_exit), m_exit), m_exit)
        return [l1, l2, apply_mask(x, m_exit)]


@BACKBONES.register("xception")
def xception(bn_mom: float = 0.1):
    return Xception(bn_mom=bn_mom)
