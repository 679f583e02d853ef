"""Stage-3 backbones, NCHW: the dilated ResNet family and the ResNet-38
variant (counterpart of wseg_tpu/seg/backbones.py; reference
segmentation/lib/net/backbone/{resnet,resnet38d}.py). Xception is
seg/xception.py.

Every BN trains with batch statistics (`frozen=False`). Module names are the
reference's, so `state_dict()` keys equal its keys: the deep-base stem is the
Sequential `conv1.{0,1,3,4,6}` (conv, bn, relu, conv, bn, relu, conv), the
7x7 stem (`deep_base=False`) the conv `conv1`, then `bn1`,
`layerX.i.{conv1,bn1,...}` and `layerX.0.downsample.{0,1}`.

Each backbone returns a list of feature taps and declares each tap's stride
(`feature_strides`) and channels (`feature_dims`).

`valid_hw` (N, 2) marks per-sample valid regions when a batch is zero-padded
to a common (bucketed) shape: the pad halo is re-zeroed after every relu,
and after the max pool, so valid outputs equal the exact-shape forward.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models.layers import BatchNorm2d, conv
from wseg_tpu_torch.models.resnet38 import ResNet38, apply_mask, valid_mask
from wseg_tpu_torch.utils.registry import BACKBONES


def _bn(bn_mom: float):
    return partial(BatchNorm2d, frozen=False, momentum=bn_mom)


class BasicBlock(nn.Module):
    """Post-activation basic block (resnet.py BasicBlock)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, downsample: bool = False, bn_mom: float = 0.1):
        super().__init__()
        bn = _bn(bn_mom)
        self.conv1 = conv(inplanes, planes, 3, stride, dilation=dilation, padding=dilation)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, dilation=previous_dilation,
                          padding=previous_dilation)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride), bn(planes))
                           if downsample else None)

    def forward(self, x, mask_in=None, mask_out=None):
        """mask_out: the valid-region mask at the output (post-stride)
        resolution; mask_in is unused (the stride sits on conv1)."""
        out = apply_mask(torch.relu(self.bn1(self.conv1(x))), mask_out)
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return apply_mask(torch.relu(out + residual), mask_out)


class Bottleneck(nn.Module):
    """Post-activation bottleneck (resnet.py Bottleneck), stride on conv2."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, downsample: bool = False, bn_mom: float = 0.1):
        super().__init__()
        bn = _bn(bn_mom)
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation=dilation, padding=dilation)
        self.bn2 = bn(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = bn(planes * 4)
        self.downsample = (nn.Sequential(conv(inplanes, planes * 4, 1, stride), bn(planes * 4))
                           if downsample else None)

    def forward(self, x, mask_in=None, mask_out=None):
        """mask_in / mask_out: valid-region masks at the input / post-stride
        resolution (the first relu is still at the input's)."""
        out = apply_mask(torch.relu(self.bn1(self.conv1(x))), mask_in)
        out = apply_mask(torch.relu(self.bn2(self.conv2(out))), mask_out)
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return apply_mask(torch.relu(out + residual), mask_out)


class DilatedResNet(nn.Module):
    """Returns [l1, l2, l3, l4] like the reference's ResNet.forward. The
    deep 3x3x3 stem (`deep_base`) or a 7x7 one; `dilated` keeps layers 3 / 4
    at stride 8 with dilations 2 / 4 (output stride 8), else they stride 2
    each (output stride 32); `multi_grid` gives layer4's blocks dilations
    (3, 4, 5)."""

    MULTI_GRID = (3, 4, 5)

    def __init__(self, block, layers, dilated: bool = True, multi_grid: bool = False,
                 deep_base: bool = True, bn_mom: float = 0.1):
        super().__init__()
        bn = _bn(bn_mom)
        # (planes, stride, dilation, input stride, output stride) of each layer
        self.layer_specs = ((64, 1, 1, 4, 4), (128, 2, 1, 4, 8)) + (
            ((256, 1, 2, 8, 8), (512, 1, 4, 8, 8)) if dilated
            else ((256, 2, 1, 8, 16), (512, 2, 1, 16, 32)))
        self.feature_strides = tuple(spec[-1] for spec in self.layer_specs)
        self.feature_dims = tuple(spec[0] * block.expansion for spec in self.layer_specs)
        self.deep_base = deep_base
        if deep_base:
            self.conv1 = nn.Sequential(
                conv(3, 64, 3, 2, padding=1), bn(64), nn.ReLU(),
                conv(64, 64, 3, 1, padding=1), bn(64), nn.ReLU(),
                conv(64, 128, 3, 1, padding=1))
            inplanes = 128
        else:
            self.conv1 = conv(3, 64, 7, 2, padding=3)
            inplanes = 64
        self.bn1 = bn(inplanes)
        for li, ((planes, stride, dilation, _, _), n) in enumerate(zip(self.layer_specs,
                                                                        layers)):
            blocks = nn.ModuleList()
            grid = multi_grid and li == 3
            for i in range(n):
                if i == 0:
                    dil = self.MULTI_GRID[0] if grid else (1 if dilation in (1, 2) else 2)
                    blocks.append(block(
                        inplanes, planes, stride=stride, dilation=dil, previous_dilation=dilation,
                        downsample=stride != 1 or inplanes != planes * block.expansion,
                        bn_mom=bn_mom))
                else:
                    dil = self.MULTI_GRID[min(i, 2)] if grid else dilation
                    blocks.append(block(inplanes, planes, dilation=dil,
                                        previous_dilation=dilation, bn_mom=bn_mom))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", blocks)
        self.OUTPUT_DIM = inplanes

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        h0, w0 = x.shape[-2:]

        def mask(stride: int):
            if valid_hw is None:
                return None
            return valid_mask(valid_hw, (-(-h0 // stride), -(-w0 // stride)),
                              stride).to(x.dtype)

        m2 = mask(2)
        if self.deep_base:
            c = self.conv1
            x = apply_mask(torch.relu(c[1](c[0](x))), m2)
            x = apply_mask(torch.relu(c[4](c[3](x))), m2)
            x = c[6](x)
        else:
            x = self.conv1(x)
        x = apply_mask(torch.relu(self.bn1(x)), m2)
        # valid outputs of the pool are pad-safe after the relu, but halo
        # outputs pick up valid values through the window overlap: re-zero
        # them before the first 3x3 block conv reads the halo
        x = apply_mask(F.max_pool2d(x, 3, stride=2, padding=1), mask(4))
        taps = []
        for li, (*_, s_in, s_out) in enumerate(self.layer_specs):
            m_in, m_out = mask(s_in), mask(s_out)
            for i, blk in enumerate(getattr(self, f"layer{li + 1}")):
                x = blk(x, mask_in=m_in if i == 0 else m_out, mask_out=m_out)
            taps.append(x)
        return taps


class SegResNet38(ResNet38):
    """The ResNet-38 trunk for segmentation, returning [conv4, conv5, conv6]
    (backbone/resnet38d.py:162-190) with batch-statistics BN at momentum 3e-4
    and a trainable conv1a: the reference's stage-3 training scripts never call
    `net.train()`, so its BN-freeze override is dead code there
    (wseg_tpu/seg/backbones.py:192-214)."""

    OUTPUT_DIM = 4096
    feature_strides = (8, 8, 8)
    feature_dims = (512, 1024, 4096)

    def __init__(self):
        super().__init__(bn_frozen=False)

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        d = super().forward(x, valid_hw)
        return [d["conv4"], d["conv5"], d["conv6"]]


@BACKBONES.register("resnet38")
def resnet38(bn_mom: float = 0.1):
    """`bn_mom` is ignored: every trunk BN keeps the module constant 3e-4
    (resnet38d.py:8), as the JAX package's resnet38_backbone does."""
    return SegResNet38()


@BACKBONES.register("resnet18")
def resnet18(bn_mom: float = 0.1):
    return DilatedResNet(BasicBlock, (2, 2, 2, 2), bn_mom=bn_mom)


@BACKBONES.register("resnet34")
def resnet34(bn_mom: float = 0.1):
    return DilatedResNet(BasicBlock, (3, 4, 6, 3), bn_mom=bn_mom)


@BACKBONES.register("resnet50")
def resnet50(bn_mom: float = 0.1):
    return DilatedResNet(Bottleneck, (3, 4, 6, 3), bn_mom=bn_mom)


@BACKBONES.register("resnet101")
def resnet101(bn_mom: float = 0.1):
    return DilatedResNet(Bottleneck, (3, 4, 23, 3), bn_mom=bn_mom)


@BACKBONES.register("resnet152")
def resnet152(bn_mom: float = 0.1):
    return DilatedResNet(Bottleneck, (3, 8, 36, 3), bn_mom=bn_mom)


def build_backbone(name: str, bn_mom: float = 0.1) -> nn.Module:
    return BACKBONES.get(name)(bn_mom=bn_mom)
