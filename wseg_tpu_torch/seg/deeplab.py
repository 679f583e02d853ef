"""DeepLab v1 / v2 heads and the ASPP operator, NCHW (counterpart of
wseg_tpu/seg/deeplab.py; reference segmentation/lib/net/{deeplabv1,
deeplabv2}.py and operators/ASPP.py).

BN trains with batch statistics at momentum TRAIN_BN_MOM; the reference's
`get_parameter_groups` collects only the convs, so BN affine stays at init
(train/optim.py:seg_label_params). Module names are the reference's: the
ASPP branches and `conv_cat` are Sequential (conv, bn, relu), so keys read
`aspp.branch1.0.weight`, `aspp.branch1.1.running_mean`, ...

`valid_hw` (N, 2) marks each sample's valid region in a zero-padded
(bucketed) batch: the pad halo is re-zeroed through the backbone and the
head and ASPP's global branch averages over the valid region, so with
`raw_logits=True` each sample's valid stride-8 logits equal its exact-shape
forward (the caller crops them and upsamples, cli/seg_test.py).

Left for later: DeepLabV1Caffe, DeepLabV3, DeepLabV3Plus, PPM and the
Xception backbone (deeplab.py:92-112, 160-212, 245-312, seg/xception.py).
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout, conv, he_normal_
from wseg_tpu_torch.models.resnet38 import apply_mask, valid_mask
from wseg_tpu_torch.ops.resize import resize_bilinear
from wseg_tpu_torch.seg.backbones import build_backbone
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.utils.registry import MODELS


class ConvBNReLU(nn.Sequential):
    """conv -> batch-statistics BN -> relu, then the halo mask
    (deeplab.py:27-40)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dilation: int = 1,
                 bn_mom: float = 0.1):
        super().__init__(conv(in_ch, out_ch, kernel, dilation=dilation),
                         BatchNorm2d(out_ch, frozen=False, momentum=bn_mom), nn.ReLU())

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        return apply_mask(super().forward(x), mask)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (deeplab.py:43-89): a branch per rate (a
    1x1 first branch at rate 0), an optional global-pooling branch whose mean
    runs over the valid region under a mask, concat, a 1x1 `conv_cat`, then
    element-wise dropout 0.5 in train mode."""

    def __init__(self, dim_in: int, dim_out: int, rate=(1, 6, 12, 18), bn_mom: float = 0.1,
                 has_global: bool = True):
        super().__init__()
        self.n_rates, self.has_global = len(rate), has_global
        for i, r in enumerate(rate):
            k = 1 if (i == 0 and r == 0) else 3
            setattr(self, f"branch{i + 1}",
                    ConvBNReLU(dim_in, dim_out, k, dilation=max(r, 1), bn_mom=bn_mom))
        if has_global:
            self.branch5_conv = conv(dim_in, dim_out, 1)
            self.branch5_bn = BatchNorm2d(dim_out, frozen=False, momentum=bn_mom)
        self.conv_cat = ConvBNReLU(dim_out * (len(rate) + has_global), dim_out, 1, bn_mom=bn_mom)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        branches = [getattr(self, f"branch{i + 1}")(x, mask) for i in range(self.n_rates)]
        if self.has_global:
            if mask is None:
                g = x.mean(dim=(2, 3), keepdim=True)
            else:
                g = (x * mask).sum(dim=(2, 3), keepdim=True) / mask.sum(dim=(2, 3), keepdim=True)
            g = torch.relu(self.branch5_bn(self.branch5_conv(g)))
            branches.append(g.expand(-1, -1, *x.shape[-2:]))
        return self.dropout(self.conv_cat(torch.cat(branches, dim=1), mask))


def mask_for(valid_hw: torch.Tensor | None, in_hw, feat_hw, stride: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor | None:
    """Valid-region mask at the backbone's output resolution. `stride` is
    the backbone's declared output stride: several strides can give the same
    padded feature shape while disagreeing on the valid extents ceil(v / s),
    so it is checked against the shape, not derived from it
    (deeplab.py:315-333)."""
    if valid_hw is None:
        return None
    fh, fw = int(feat_hw[0]), int(feat_hw[1])
    if (-(-int(in_hw[0]) // stride), -(-int(in_hw[1]) // stride)) != (fh, fw):
        raise ValueError(f"backbone output stride {stride} inconsistent with input "
                         f"{tuple(in_hw)} -> features {(fh, fw)}")
    return valid_mask(valid_hw, (fh, fw), stride).to(dtype)


class _DeepLab(nn.Module):
    """The backbone of `cfg.MODEL_BACKBONE`, a head that `_head` applies, and
    `cls_conv` (1x1 with bias); the output is the stride-8 logits with
    `raw_logits`, else their align_corners=True upsample to the input size.
    `generator` seeds the init (He-normal convs, zero biases, identity BN);
    it defaults to seed 0."""

    def __init__(self, cfg: SegConfig, head_dim: int):
        super().__init__()
        self.backbone = build_backbone(cfg.MODEL_BACKBONE, bn_mom=cfg.TRAIN_BN_MOM)
        self.dropout = Dropout(0.5)
        self.cls_conv = conv(head_dim, cfg.MODEL_NUM_CLASSES, 1, bias=True)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        generator = generator or torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                m.running_mean.fill_(0.0)
                m.running_var.fill_(1.0)

    def _head(self, bottom: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None,
                raw_logits: bool = False) -> torch.Tensor:
        h, w = x.shape[-2:]
        bottom = self.backbone(x, valid_hw)[-1]
        m8 = mask_for(valid_hw, (h, w), bottom.shape[-2:], self.backbone.feature_strides[-1],
                      x.dtype)
        out = self.cls_conv(self.dropout(self._head(bottom, m8)))
        return out if raw_logits else resize_bilinear(out, (h, w), align_corners=True)


@MODELS.register("deeplabv1")
class DeepLabV1(_DeepLab):
    """deeplabv1.py:11-69: conv_fov 3x3 at dilation 12 -> 512, BN, relu;
    conv_fov2 1x1, BN, relu; element-wise dropout 0.5; cls_conv."""

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, 512)
        bn = partial(BatchNorm2d, frozen=False, momentum=cfg.TRAIN_BN_MOM)
        self.conv_fov = conv(self.backbone.OUTPUT_DIM, 512, 3, dilation=12, padding=12)
        self.bn_fov = bn(512)
        self.conv_fov2 = conv(512, 512, 1)
        self.bn_fov2 = bn(512)
        self.reset_parameters(generator)

    def _head(self, bottom, mask):
        f = apply_mask(torch.relu(self.bn_fov(self.conv_fov(bottom))), mask)
        return apply_mask(torch.relu(self.bn_fov2(self.conv_fov2(f))), mask)


@MODELS.register("deeplabv2")
class DeepLabV2(_DeepLab):
    """deeplabv2.py:40-59: ASPP at rates (6, 12, 18, 24), dropout 0.5,
    cls_conv."""

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, cfg.MODEL_ASPP_OUTDIM)
        self.aspp = ASPP(self.backbone.OUTPUT_DIM, cfg.MODEL_ASPP_OUTDIM, rate=(6, 12, 18, 24),
                         bn_mom=cfg.TRAIN_BN_MOM, has_global=cfg.MODEL_ASPP_HASGLOBAL)
        self.reset_parameters(generator)

    def _head(self, bottom, mask):
        return self.aspp(bottom, mask)


def generate_net(cfg: SegConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> nn.Module:
    """The registered net of `cfg.MODEL_NAME` on `device` (the GPU unless the
    caller passes "cpu"; channels_last there), lib/net/generateNet.py:14-16."""
    return build_model(cfg.MODEL_NAME, device=device, cfg=cfg, generator=generator)
