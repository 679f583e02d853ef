"""DeepLab v1 / v1-caffe / v2 / v3 / v3+ heads and the ASPP and PPM
operators, NCHW (counterpart of wseg_tpu/seg/deeplab.py; reference
segmentation/lib/net/{deeplabv1,deeplabv2,deeplabv3,deeplabv3plus}.py and
operators/{ASPP,PPM}.py).

BN trains with batch statistics at momentum TRAIN_BN_MOM; the reference's
`get_parameter_groups` collects only the convs, so BN affine stays at init
(train/optim.py:seg_label_params). Module names are the reference's: the
ASPP branches, `conv_cat`, the PPM bins and v3+'s `shortcut_conv` and
`cat_conv1/2` are Sequential (conv, bn, relu), so keys read
`aspp.branch1.0.weight`, `aspp.branch1.1.running_mean`, ...

`valid_hw` (N, 2) marks each sample's valid region in a zero-padded
(bucketed) batch: the pad halo is re-zeroed through the backbone and the
head and ASPP's global branch averages over the valid region, so with
`raw_logits=True` each sample's valid logits equal its exact-shape forward
(the caller crops them and upsamples, cli/seg_test.py). v3+ is the
exception, as in the JAX package: its stride-8 -> stride-4 upsample maps
over the padded grid, so one interpolation cell at the valid edge differs.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout, conv, he_normal_
from wseg_tpu_torch.models.resnet38 import apply_mask, valid_mask
from wseg_tpu_torch.ops.resize import resize_bilinear
from wseg_tpu_torch.seg import xception  # noqa: F401  (registers the "xception" backbone)
from wseg_tpu_torch.seg.backbones import build_backbone
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.utils.profiling import span
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


class PPM(nn.Module):
    """PSPNet pyramid pooling (deeplab.py:92-112 of the JAX package;
    operators/PPM.py), registered but unused by the reference's
    experiments: per bin b, an adaptive b x b mean pool, a 1x1 conv + BN +
    relu, an align_corners=True upsample back; concatenated after the input.
    The pool is a reshape-mean over the top-left (h // b * b, w // b * b)
    block, as the JAX package pools; `F.adaptive_avg_pool2d`'s bins
    overlap where h % b != 0."""

    def __init__(self, dim_in: int, dim_out: int, bins=(1, 2, 3, 6), bn_mom: float = 0.1):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            setattr(self, f"bin{i}", ConvBNReLU(dim_in, dim_out, 1, bn_mom=bn_mom))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        outs = [x]
        for i, b in enumerate(self.bins):
            ph, pw = h // b, w // b
            pooled = x[:, :, :ph * b, :pw * b].reshape(n, c, b, ph, b, pw).mean((3, 5))
            outs.append(resize_bilinear(getattr(self, f"bin{i}")(pooled), (h, w),
                                        align_corners=True))
        return torch.cat(outs, dim=1)


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
    """The backbone of `cfg.MODEL_BACKBONE`, a head that `_head` applies to
    its taps, and `cls_conv` (1x1 with bias); the output is the head's
    logits (stride 8; stride 4 for v3+) with `raw_logits`, else their
    align_corners=True upsample to the input size. The backbone runs under
    the span `seg.backbone`, the rest under `seg.head` (utils/profiling.py).
    `generator` seeds the init (He-normal convs, zero biases, identity BN);
    it defaults to seed 0. FROM_SCRATCH names the head convs the reference
    trains from scratch when they are not all of them (seg_label_params)."""

    FROM_SCRATCH: tuple | None = None

    def __init__(self, cfg: SegConfig, head_dim: int):
        super().__init__()
        self.backbone = build_backbone(cfg.MODEL_BACKBONE, bn_mom=cfg.TRAIN_BN_MOM)
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

    def _head(self, feats: list, mask_at) -> torch.Tensor:
        """The head on the backbone's taps; `mask_at(i)` is the valid-region
        mask at tap i's resolution (None without valid_hw)."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None,
                raw_logits: bool = False) -> torch.Tensor:
        h, w = x.shape[-2:]
        with span("seg.backbone"):
            feats = self.backbone(x, valid_hw)

        def mask_at(i: int):
            return mask_for(valid_hw, (h, w), feats[i].shape[-2:],
                            self.backbone.feature_strides[i], x.dtype)

        with span("seg.head"):
            out = self.cls_conv(self._head(feats, mask_at))
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
        self.dropout = Dropout(0.5)
        self.reset_parameters(generator)

    def _head(self, feats, mask_at):
        m8 = mask_at(-1)
        f = apply_mask(torch.relu(self.bn_fov(self.conv_fov(feats[-1]))), m8)
        return self.dropout(apply_mask(torch.relu(self.bn_fov2(self.conv_fov2(f))), m8))


@MODELS.register("deeplabv1_caffe")
class DeepLabV1Caffe(_DeepLab):
    """deeplabv1.py:72-130 (`deeplabv1_caffe`), registered but unused by the
    reference's presets: a 3x3 stride-1 max pool on the backbone output,
    conv_fov 3x3 at dilation 12 -> 4096 (bias, no BN), relu, dropout 0.5,
    conv_fov2 1x1 -> 4096 (bias), relu, dropout 0.5, cls_conv. Only
    cls_conv trains from scratch (deeplabv1.py:88): conv_fov and conv_fov2
    join the pretrained groups."""

    FROM_SCRATCH = ("cls_conv",)

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, 4096)
        self.conv_fov = conv(self.backbone.OUTPUT_DIM, 4096, 3, dilation=12, padding=12,
                             bias=True)
        self.conv_fov2 = conv(4096, 4096, 1, bias=True)
        self.dropout1 = Dropout(0.5)
        self.dropout2 = Dropout(0.5)
        self.reset_parameters(generator)

    def _head(self, feats, mask_at):
        bottom, m8 = feats[-1], mask_at(-1)
        if m8 is None:
            f = F.max_pool2d(bottom, 3, stride=1, padding=1)
        else:
            # the pool pads with -inf; the bucket's pad region holds zeros,
            # so it is set to the same identity first and re-zeroed after:
            # valid outputs then equal the exact-shape forward for any sign
            valid = m8 > 0
            f = F.max_pool2d(torch.where(valid, bottom, torch.finfo(bottom.dtype).min), 3,
                             stride=1, padding=1)
            f = torch.where(valid, f, 0.0)
        f = self.dropout1(apply_mask(torch.relu(self.conv_fov(f)), m8))
        return self.dropout2(apply_mask(torch.relu(self.conv_fov2(f)), m8))


@MODELS.register("deeplabv2")
class DeepLabV2(_DeepLab):
    """deeplabv2.py:40-59: ASPP at rates (6, 12, 18, 24), dropout 0.5,
    cls_conv."""

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, cfg.MODEL_ASPP_OUTDIM)
        self.aspp = ASPP(self.backbone.OUTPUT_DIM, cfg.MODEL_ASPP_OUTDIM, rate=(6, 12, 18, 24),
                         bn_mom=cfg.TRAIN_BN_MOM, has_global=cfg.MODEL_ASPP_HASGLOBAL)
        self.dropout = Dropout(0.5)
        self.reset_parameters(generator)

    def _head(self, feats, mask_at):
        return self.dropout(self.aspp(feats[-1], mask_at(-1)))


@MODELS.register("deeplabv3")
class DeepLabV3(_DeepLab):
    """deeplabv3.py:40-53: ASPP at rates (0, 6, 12, 18), rate 0 being a 1x1
    branch, then cls_conv."""

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, cfg.MODEL_ASPP_OUTDIM)
        self.aspp = ASPP(self.backbone.OUTPUT_DIM, cfg.MODEL_ASPP_OUTDIM, rate=(0, 6, 12, 18),
                         bn_mom=cfg.TRAIN_BN_MOM, has_global=cfg.MODEL_ASPP_HASGLOBAL)
        self.reset_parameters(generator)

    def _head(self, feats, mask_at):
        return self.aspp(feats[-1], mask_at(-1))


@MODELS.register("deeplabv3plus")
class DeepLabV3Plus(_DeepLab):
    """deeplabv3plus.py:15-77: ASPP (rates (0, 6, 12, 18)) on the last tap,
    upsampled (align_corners=True) to the first tap's grid, concatenated
    with the first tap's 3x3 `shortcut_conv` (MODEL_SHORTCUT_DIM), then the
    3x3 `cat_conv1` and `cat_conv2`, then cls_conv: logits at the first
    tap's stride (4)."""

    def __init__(self, cfg: SegConfig, generator: torch.Generator | None = None):
        super().__init__(cfg, cfg.MODEL_ASPP_OUTDIM)
        dim, mom = cfg.MODEL_ASPP_OUTDIM, cfg.TRAIN_BN_MOM
        self.aspp = ASPP(self.backbone.OUTPUT_DIM, dim, rate=(0, 6, 12, 18), bn_mom=mom,
                         has_global=cfg.MODEL_ASPP_HASGLOBAL)
        self.shortcut_conv = ConvBNReLU(self.backbone.feature_dims[0], cfg.MODEL_SHORTCUT_DIM,
                                        3, bn_mom=mom)
        self.cat_conv1 = ConvBNReLU(dim + cfg.MODEL_SHORTCUT_DIM, dim, 3, bn_mom=mom)
        self.cat_conv2 = ConvBNReLU(dim, dim, 3, bn_mom=mom)
        self.reset_parameters(generator)

    def _head(self, feats, mask_at):
        l1, m4 = feats[0], mask_at(0)
        f = self.aspp(feats[-1], mask_at(-1))
        f = apply_mask(resize_bilinear(f, l1.shape[-2:], align_corners=True), m4)
        f = torch.cat([f, self.shortcut_conv(l1, m4)], dim=1)
        return self.cat_conv2(self.cat_conv1(f, m4), m4)


def generate_net(cfg: SegConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> nn.Module:
    """The registered net of `cfg.MODEL_NAME` on `device` (the GPU unless the
    caller passes "cpu"; channels_last there), lib/net/generateNet.py:14-16."""
    return build_model(cfg.MODEL_NAME, device=device, cfg=cfg, generator=generator)
