"""SEAM + pixel-to-prototype contrast network, NCHW.

Counterpart of wseg_tpu/models/contrast.py (reference
network/resnet38_contrast.py): the ResNet-38 trunk, the `fc8` 1x1 CAM head
(4096 -> 21), the 128-d projection head `fc_proj`, and PCM refinement over
concat[img_down, f8_3(conv4), f8_4(conv5)] -> f9 (195 -> 192).

The heads sit beside the trunk's blocks, as in the reference, so
`state_dict()` keys are the reference's (`conv1a.weight`, `fc8.weight`, ...).
In eval mode PCM goes through kernels/pcm_cuda.py, the CUDA kernel on a GPU
tensor and its plain version on a CPU one; in training mode it is the
differentiable ops/pcm.py formula.
"""

from __future__ import annotations

import torch
from torch import nn

from wseg_tpu_torch.kernels.pcm_cuda import pcm_fused_nchw
from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout2d, conv, he_normal_, xavier_uniform_
from wseg_tpu_torch.models.resnet38 import ResNet38, valid_mask
from wseg_tpu_torch.ops.cam import cam_bg_complete
from wseg_tpu_torch.ops.pcm import pcm
from wseg_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_valid
from wseg_tpu_torch.utils.registry import MODELS


@MODELS.register("contrast")
class ContrastNet(ResNet38):
    """`generator` seeds the random init (He-normal convs, Xavier heads,
    gain 4 on f9, identity BN); it defaults to seed 0."""

    def __init__(self, num_classes: int = 21, proj_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout7 = Dropout2d(0.5)
        self.fc_proj = conv(4096, proj_dim, 1)
        self.fc8 = conv(4096, num_classes, 1)
        self.f8_3 = conv(512, 64, 1)
        self.f8_4 = conv(1024, 128, 1)
        self.f9 = conv(3 + 64 + 128, 192, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        xavier_gain = {self.fc_proj: 1.0, self.fc8: 1.0, self.f9: 4.0}
        for m in self.modules():
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

    def forward(self, x: torch.Tensor, raw_cam: bool = False,
                valid_hw: torch.Tensor | None = None):
        """x (N, 3, H, W). Returns (cam, cam_rv, f_proj, cam_rv_down), with
        cam / cam_rv upsampled (align_corners=True) to the input size.

        raw_cam=True returns only the stride-8 (cam, cam_rv_down) pair and
        skips fc_proj: the inference path. CAM seed inference consumes the
        PCM-refined cam_rv_down.

        valid_hw (N, 2): per-sample valid sizes when the batch is zero-padded
        to a bucketed shape. Pad pixels are kept out of every global
        interaction (trunk halo, CAM max, PCM affinity), so each sample's
        valid stride-8 output equals its exact-shape forward. Needs
        raw_cam=True."""
        h_in, w_in = x.shape[-2:]
        d = super().forward(x, valid_hw)
        fea = self.dropout7(d["conv6"])
        cam = self.fc8(fea)
        h, w = cam.shape[-2:]

        m8 = None
        if valid_hw is not None:
            if not raw_cam:
                raise ValueError("valid_hw is an inference-path (raw_cam=True) feature")
            m8 = valid_mask(valid_hw, (h, w), 8).to(cam.dtype)

        # detached CAM -> normalized + bg-completed + per-pixel fg argmax
        cam_d_norm = cam_bg_complete(cam.detach(), mask=m8)

        f8_3 = torch.relu(self.f8_3(d["conv4"].detach()))
        f8_4 = torch.relu(self.f8_4(d["conv5"].detach()))
        if valid_hw is None:
            x_s = resize_bilinear(x, (h, w), align_corners=True)
        else:
            x_s = resize_bilinear_valid(x, (h, w), valid_hw, (valid_hw + 7) // 8)
        f = self.f9(torch.cat([x_s, f8_3, f8_4], dim=1))

        if self.training:
            cam_rv_down = pcm(cam_d_norm, f, mask=m8)
        else:
            cam_rv_down = pcm_fused_nchw(cam_d_norm, f, mask=m8)
        if raw_cam:
            return cam, cam_rv_down
        f_proj = torch.relu(self.fc_proj(fea))
        cam_rv = resize_bilinear(cam_rv_down, (h_in, w_in), align_corners=True)
        cam_up = resize_bilinear(cam, (h_in, w_in), align_corners=True)
        return cam_up, cam_rv, f_proj, cam_rv_down
