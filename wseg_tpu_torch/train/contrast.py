"""Stage-1 SEAM + pixel-to-prototype contrast training step (counterpart of
wseg_tpu/train/contrast.py; reference contrast_train.py:126-399), NCHW.

One dual-view step: both forwards (the crop and its low_res^2 bilinear
downscale, align_corners=True), every SEAM loss (cls, rvmin, ER, ECR),
prototype estimation, the three InfoNCE terms, the backward and the
optimizer update. Dropout on both views and the uniform keys of the
intra-view NCE come from one explicit `torch.Generator`, so a run is a
function of its seed and a resumed run of the generator's saved state.

Data parallel (a process group, parallel/mesh.py): every rank gathers the
model outputs of the global batch and computes the identical global loss
(prototypes, pseudo-labels, the class ranks and `num_present` over the
global batch's pixels; the intra-view keys drawn at the global M); the
parameter gradients are then averaged over the ranks, which makes them the
one-process gradient (the mesh module's docstring says why).
"""

from __future__ import annotations

from itertools import chain

import torch
from torch.func import functional_call

from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.ops.cam import max_norm, max_onehot
from wseg_tpu_torch.ops.losses import (
    adaptive_min_pooling_loss,
    ecr_loss,
    estimate_prototypes,
    info_nce,
    intra_view_nce,
    multilabel_soft_margin_loss,
    normalize_cam_for_prototypes,
)
from wseg_tpu_torch.ops.resize import resize_bilinear
from wseg_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_grads_, bind, size_of
from wseg_tpu_torch.train.optim import label_params
from wseg_tpu_torch.utils.profiling import span


def _l2_rows(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-12)


def contrast_losses(outputs1, outputs2, label21: torch.Tensor,
                    us: tuple[torch.Tensor, torch.Tensor], bg_threshold: float = 0.20,
                    low_res: int = 128, group=None) -> dict[str, torch.Tensor]:
    """All stage-1 losses from the two views' outputs.

    outputs*: (cam, cam_rv, f_proj, cam_rv_down) NCHW model outputs of the
    crop and of its low_res downscale; label21 (N, 21) multi-hot with bg = 1
    (contrast_train.py:138-140); us: the uniform (M,) keys of the two views'
    intra-view NCE (M = N * (low_res // 8)^2 pixels each).

    With a process `group`, the arguments are this rank's rows (`us` is the
    global batch's) and every rank returns the global batch's losses: the
    outputs and labels are gathered first. Its backward then gives this
    rank's outputs W times their one-process gradient (W ranks' identical
    losses); the train step averages the parameter gradients."""
    if group is not None:
        outputs1, outputs2 = (tuple(all_gather_rows(t, group) for t in outs)
                              for outs in (outputs1, outputs2))
        label21 = all_gather_rows(label21, group)
    cam1, cam_rv1, f_proj1, cam_rv1_down = outputs1
    cam2, cam_rv2, f_proj2, cam_rv2_down = outputs2
    lbl = label21[:, :, None, None]

    # SEAM losses (contrast_train.py:142-174)
    label1 = cam1.mean(dim=(2, 3))  # adaptive_avg_pool2d -> (N, 21)
    label2 = cam2.mean(dim=(2, 3))
    loss_rvmin1 = adaptive_min_pooling_loss((cam_rv1 * lbl)[:, 1:])
    loss_rvmin2 = adaptive_min_pooling_loss((cam_rv2 * lbl)[:, 1:])

    low = (low_res, low_res)
    cam1n = resize_bilinear(max_norm(cam1), low, align_corners=True) * lbl
    cam_rv1n = resize_bilinear(max_norm(cam_rv1), low, align_corners=True) * lbl
    cam2n = max_norm(cam2) * lbl
    cam_rv2n = max_norm(cam_rv2) * lbl

    loss_cls1 = multilabel_soft_margin_loss(label1[:, 1:], label21[:, 1:])
    loss_cls2 = multilabel_soft_margin_loss(label2[:, 1:], label21[:, 1:])
    loss_er = (cam1n[:, 1:] - cam2n[:, 1:]).abs().mean()

    def bg_complete(c):
        return torch.cat([1.0 - c[:, 1:].amax(dim=1, keepdim=True), c[:, 1:]], dim=1)

    cam1n = bg_complete(cam1n)
    cam2n = bg_complete(cam2n)
    loss_ecr = (ecr_loss(max_onehot(cam2n.detach()), cam_rv1n)
                + ecr_loss(max_onehot(cam1n.detach()), cam_rv2n))
    loss_cls = (loss_cls1 + loss_cls2) / 2 + (loss_rvmin1 + loss_rvmin2) / 2

    # contrast block (contrast_train.py:176-392)
    ds = (low_res // 8, low_res // 8)
    f_proj1 = resize_bilinear(f_proj1, ds, align_corners=True)
    cam_rv1_down = resize_bilinear(cam_rv1_down, ds, align_corners=True)
    protos1, pl1 = estimate_prototypes(
        f_proj1.detach(), normalize_cam_for_prototypes(cam_rv1_down.detach(), bg_threshold),
        label21)
    protos2, pl2 = estimate_prototypes(
        f_proj2.detach(), normalize_cam_for_prototypes(cam_rv2_down.detach(), bg_threshold),
        label21)

    cf = f_proj1.shape[1]
    f1 = _l2_rows(f_proj1.permute(0, 2, 3, 1).reshape(-1, cf))
    f2 = _l2_rows(f_proj2.permute(0, 2, 3, 1).reshape(-1, cf))

    # 1.1 cross-prototype NCE (:259-269); 1.2 cross-pseudo-label NCE (:271-281)
    loss_cross_nce = 0.1 * (info_nce(f1, protos2[pl1], protos2)
                            + info_nce(f2, protos1[pl2], protos1)) / 2
    loss_cross_nce2 = 0.1 * (info_nce(f1, protos1[pl2], protos1)
                             + info_nce(f2, protos2[pl1], protos2)) / 2
    # 2. intra-view NCE with semi-hard mining and hard pixel sampling (:283-389)
    loss_intra_nce = 0.1 * (intra_view_nce(f1, protos1, pl1, us[0])
                            + intra_view_nce(f2, protos2, pl2, us[1])) / 2

    loss_nce = loss_cross_nce + loss_cross_nce2 + loss_intra_nce
    return {
        "loss": loss_cls + loss_er + loss_ecr + loss_nce,
        "loss_cls": loss_cls,
        "loss_er": loss_er,
        "loss_ecr": loss_ecr,
        "loss_nce": loss_nce,
        "loss_intra_nce": loss_intra_nce,
        "loss_cross_nce": loss_cross_nce,
        "loss_cross_nce2": loss_cross_nce2,
    }


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float):
    """Scale `grads` in place to a global L2 norm of at most `max_norm`, as
    optax.clip_by_global_norm does (no epsilon)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    bg_threshold: float = 0.20, low_res: int = 128,
                    compute_dtype: torch.dtype | None = None, grad_clip: float = 0.0,
                    generator: torch.Generator | None = None, group=None):
    """Build `step(img (N, 3, H, W), label (N, 20), us=None) -> metrics`.

    With a process `group` (parallel/mesh.py), `img` and `label` are this
    rank's rows of the global batch and the step is the one-process step at
    that batch: global losses, dropout and keys drawn at the global shape,
    the gradients averaged over the ranks before clipping. `us` is then the
    global batch's keys.

    The step runs the model in training mode (dropout on, the plain
    differentiable PCM; BN is frozen either way), backpropagates the total
    loss and applies `optimizer`. `generator` (on the model's device; seed 0
    by default) drives dropout and, unless `us` is given, the intra-view NCE
    keys. Metrics come back as detached device tensors: reading them syncs.

    float32 (compute_dtype None) means float32: on CUDA this turns off TF32
    for matmuls and cuDNN convs (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32), process-wide.
    compute_dtype=torch.bfloat16 is the opt-in mixed-precision step: the
    forward and backward run on bf16 copies of the parameters and buffers,
    the losses in float32, and the gradients land in float32 on the float32
    master parameters.

    grad_clip > 0 clips by the global norm of every parameter's gradient, the
    frozen ones included, as the JAX trainer does; the frozen parameters then
    need gradients. With grad_clip == 0 they get none (the optimizer leaves
    them unchanged either way), which spares the backward through the frozen
    trunk blocks and BN affines."""
    device = next(model.parameters()).device
    if device.type == "cuda" and compute_dtype is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
    bind(model, group)
    labels = label_params(model)
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(grad_clip > 0)
    model.train()

    def forward(x):
        if compute_dtype is None:
            return model(x)
        tensors = {n: t.to(compute_dtype) if t.is_floating_point() else t
                   for n, t in chain(model.named_parameters(), model.named_buffers())}
        out = functional_call(model, tensors, (x.to(compute_dtype),))
        return tuple(o.float() for o in out)

    def step(img: torch.Tensor, label: torch.Tensor, us=None) -> dict[str, torch.Tensor]:
        with span("train.step"):
            n = img.shape[0] * size_of(group)  # the global batch
            label = label.to(device=img.device, dtype=torch.float32)
            label21 = torch.cat([torch.ones_like(label[:, :1]), label], dim=1)
            with span("train.forward"):
                img2 = resize_bilinear(img, (low_res, low_res), align_corners=True)
                out1 = forward(img)
                out2 = forward(img2)
            if us is None:
                m1 = n * (low_res // 8) ** 2
                m2 = n * out2[2].shape[2] * out2[2].shape[3]
                us = (torch.rand(m1, generator=generator, device=img.device),
                      torch.rand(m2, generator=generator, device=img.device))
            with span("train.losses"):
                metrics = contrast_losses(out1, out2, label21, us, bg_threshold, low_res, group)
            with span("train.backward"):
                optimizer.zero_grad(set_to_none=True)
                metrics["loss"].backward()
                all_reduce_grads_(model.parameters(), group)
                if grad_clip > 0:
                    clip_by_global_norm_(
                        [p.grad for p in model.parameters() if p.grad is not None], grad_clip)
            with span("train.optimizer"):
                optimizer.step()
            return {k: v.detach() for k, v in metrics.items()}

    return step
