"""AffinityNet: the pixel-pair affinity head over the ResNet-38 trunk, NCHW.

Counterpart of wseg_tpu/models/affinity.py (reference
network/resnet38_aff.py): ELU 1x1 taps f8_3 (conv4, 512 -> 64), f8_4
(conv5, 1024 -> 128) and f8_5 (conv6, 4096 -> 256), concatenated, then the
ELU f9 (448 -> 448, Xavier gain 4); the output is the pairwise affinity
exp(-mean |f[to] - f[from]|) over the radius-5 half-disc pairs, or the
per-image dense matrix with `to_dense=True`.

The heads sit beside the trunk's blocks, as in the reference, so
`state_dict()` keys are the reference's `resnet38_aff` keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wseg_tpu_torch.models.layers import conv, init_weights
from wseg_tpu_torch.models.resnet38 import ResNet38
from wseg_tpu_torch.ops.pairs import (
    dense_affinity_matrix,
    pairwise_affinity,
    pairwise_affinity_sliced,
    pair_index_tensors,
)
from wseg_tpu_torch.utils.registry import MODELS

PAIR_IMPLS = ("sliced", "gather")


def clamped_radius(h: int, w: int, radius: int) -> int:
    """The head's radius on an (h, w) stride-8 map: small maps take the
    largest radius whose cropped frame is not empty (affinity.py:47-49)."""
    min_edge = min(h, w)
    return (min_edge - 1) // 2 if min_edge < radius * 2 + 1 else radius


@MODELS.register("affinity")
class AffinityNet(ResNet38):
    """`pair_impl`: "sliced" (one shifted window per displacement; the
    default) or "gather" (index gathers, as the reference). `generator` seeds
    the random init (He-normal convs, Xavier gain 4 on f9, identity BN); it
    defaults to seed 0."""

    def __init__(self, radius: int = 5, pair_impl: str = "sliced",
                 generator: torch.Generator | None = None):
        super().__init__()
        if pair_impl not in PAIR_IMPLS:
            raise ValueError(f"pair_impl must be one of {PAIR_IMPLS}, got {pair_impl!r}")
        self.radius = radius
        self.pair_impl = pair_impl
        self.f8_3 = conv(512, 64, 1)
        self.f8_4 = conv(1024, 128, 1)
        self.f8_5 = conv(4096, 256, 1)
        self.f9 = conv(448, 448, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        init_weights(self, generator, {self.f9: 4.0})

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The (N, 448, H/8, W/8) f9 features the affinities compare."""
        d = super().forward(x)
        f = torch.cat([F.elu(self.f8_3(d["conv4"])), F.elu(self.f8_4(d["conv5"])),
                       F.elu(self.f8_5(d["conv6"]))], dim=1)
        return F.elu(self.f9(f))

    def forward(self, x: torch.Tensor, to_dense: bool = False) -> torch.Tensor:
        """x (N, 3, H, W) -> (N, D, P) pair affinities, or with to_dense=True
        (N = 1) the (hw, hw) dense affinity matrix of the one image."""
        f = self.features(x)
        h, w = f.shape[-2:]
        radius = clamped_radius(h, w, self.radius)
        if self.pair_impl == "sliced":
            aff = pairwise_affinity_sliced(f, radius)
        else:
            aff = pairwise_affinity(f, *pair_index_tensors(radius, (h, w), f.device))
        if not to_dense:
            return aff
        if f.shape[0] != 1:
            raise ValueError("the dense affinity matrix is per image (N = 1)")
        return dense_affinity_matrix(aff[0], *pair_index_tensors(radius, (h, w), f.device),
                                     h * w)

