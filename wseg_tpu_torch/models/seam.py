"""The baseline SEAM network (no projection head), NCHW.

Counterpart of wseg_tpu/models/seam.py (reference network/resnet38_SEAM.py):
the ResNet-38 trunk, the `fc8` 1x1 CAM head and PCM refinement over
concat[img_down, f8_3(conv4), f8_4(conv5)] -> f9, with the whole PCM branch
under `torch.no_grad()` (the reference's, :36-52). Returns (cam, cam_rv)
upsampled (align_corners=True) to the input size.

State_dict keys are the reference's `resnet38_SEAM` keys, so
`utils/checkpoint.py:state_dict_from_jax` maps the JAX SEAMNet tree as it
maps the JAX ContrastNet's. PCM has no gradient here, so on a GPU it always
goes through the CUDA kernel (kernels/pcm_cuda.py: the FMA kernel for f32
features, the tensor-core one for bf16), and on the CPU through the plain
ops/pcm.py formula.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.kernels.pcm_cuda import pcm_fused_nchw
from wseg_tpu_torch.models.layers import Dropout2d, conv, init_weights
from wseg_tpu_torch.models.resnet38 import ResNet38
from wseg_tpu_torch.ops.cam import cam_bg_complete
from wseg_tpu_torch.ops.pcm import pcm
from wseg_tpu_torch.ops.resize import resize_bilinear
from wseg_tpu_torch.utils.registry import MODELS


@MODELS.register("seam")
class SEAMNet(ResNet38):
    """`generator` seeds the random init (He-normal convs, Xavier fc8 and
    f9, gain 4 on f9, identity BN); it defaults to seed 0."""

    def __init__(self, num_classes: int = 21, generator: torch.Generator | None = None):
        super().__init__()
        self.dropout7 = Dropout2d(0.5)
        self.fc8 = conv(4096, num_classes, 1)
        self.f8_3 = conv(512, 64, 1)
        self.f8_4 = conv(1024, 128, 1)
        self.f9 = conv(3 + 64 + 128, 192, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        init_weights(self, generator, {self.fc8: 1.0, self.f9: 4.0})

    def forward(self, x: torch.Tensor):
        """x (N, 3, H, W) -> (cam, cam_rv), both (N, 21, H, W); only `cam`
        carries a gradient."""
        h_in, w_in = x.shape[-2:]
        d = super().forward(x)
        cam = self.fc8(self.dropout7(d["conv6"]))
        h, w = cam.shape[-2:]
        with torch.no_grad():
            cam_d_norm = cam_bg_complete(cam)
            f8_3 = torch.relu(self.f8_3(d["conv4"]))
            f8_4 = torch.relu(self.f8_4(d["conv5"]))
            x_s = resize_bilinear(x, (h, w), align_corners=True)
            f = self.f9(torch.cat([x_s, f8_3, f8_4], dim=1))
            cam_rv_down = (pcm_fused_nchw if f.is_cuda else pcm)(cam_d_norm, f)
        cam_rv = resize_bilinear(cam_rv_down, (h_in, w_in), align_corners=True)
        cam_up = resize_bilinear(cam, (h_in, w_in), align_corners=True)
        return cam_up, cam_rv
