"""AffinityNet training step, stage 2 (counterpart of
wseg_tpu/train/affinity.py; reference aff_train.py:101-123).

Count-normalised cross-entropy of the predicted pair affinities against the
(bg_pos, fg_pos, neg) targets, loss = bg/4 + fg/4 + neg/2. Dropout (b6, b7)
draws from one explicit `torch.Generator`, so a run is a function of its
seed and a resumed run of the generator's saved state.

Data parallel (a process group, parallel/mesh.py): the three sums and the
three label counts are summed over the ranks, so every rank computes the
identical global loss, and the parameter gradients are averaged over the
ranks, which makes them the one-process gradient.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.parallel.mesh import all_reduce_grads_, all_reduce_sum, bind
from wseg_tpu_torch.train.optim import label_params


def affinity_losses(aff: torch.Tensor, bg_label: torch.Tensor, fg_label: torch.Tensor,
                    neg_label: torch.Tensor, group=None) -> dict[str, torch.Tensor]:
    """aff: (N, D, P) predicted affinities; the labels have its shape. With a
    process `group` they are this rank's rows, and every rank returns the
    global batch's losses (sums and counts summed over the ranks)."""
    sums = torch.stack([(-bg_label * torch.log(aff + 1e-5)).sum(),
                        (-fg_label * torch.log(aff + 1e-5)).sum(),
                        (-neg_label * torch.log(1.0 + 1e-5 - aff)).sum(),
                        bg_label.sum(), fg_label.sum(), neg_label.sum()])
    if group is not None:
        sums = all_reduce_sum(sums, group)
    bg_count, fg_count, neg_count = sums[3:] + 1e-5
    bg_loss, fg_loss, neg_loss = sums[0] / bg_count, sums[1] / fg_count, sums[2] / neg_count
    return {
        "loss": bg_loss / 4 + fg_loss / 4 + neg_loss / 2,
        "bg_loss": bg_loss, "fg_loss": fg_loss, "neg_loss": neg_loss,
        "bg_cnt": bg_count, "fg_cnt": fg_count, "neg_cnt": neg_count,
    }


def make_aff_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        generator: torch.Generator | None = None, group=None):
    """Build `step(img (N, 3, H, W), bg, fg, neg) -> metrics`.

    With a process `group` (parallel/mesh.py) the arguments are this rank's
    rows of the global batch and the step is the one-process step at that
    batch: global losses, dropout drawn at the global shape, the gradients
    averaged over the ranks.

    The step runs the model in training mode (dropout on; BN is frozen
    either way), backpropagates the loss and applies `optimizer`, with no
    gradient clipping, as the JAX step. The frozen parameters (conv1a, b2*,
    every BN affine) get no gradients: the optimizer never moves them, and
    without clipping nothing else reads them. `generator` (on the model's
    device; seed 0 by default) drives dropout. Metrics come back as detached
    device tensors: reading them syncs.

    On CUDA this turns off TF32 for matmuls and cuDNN convs, process-wide:
    the step is float32, as the JAX one."""
    device = next(model.parameters()).device
    if device.type == "cuda":
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
        p.requires_grad_(labels[name] != "frozen")
    model.train()

    def step(img: torch.Tensor, bg_label: torch.Tensor, fg_label: torch.Tensor,
             neg_label: torch.Tensor) -> dict[str, torch.Tensor]:
        metrics = affinity_losses(model(img), bg_label, fg_label, neg_label, group)
        optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        all_reduce_grads_(model.parameters(), group)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
