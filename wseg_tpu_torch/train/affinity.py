"""AffinityNet training step, stage 2 (counterpart of
wseg_tpu/train/affinity.py; reference aff_train.py:101-123).

Count-normalised cross-entropy of the predicted pair affinities against the
(bg_pos, fg_pos, neg) targets, loss = bg/4 + fg/4 + neg/2. Dropout (b6, b7)
draws from one explicit `torch.Generator`, so a run is a function of its
seed and a resumed run of the generator's saved state.
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.train.optim import label_params


def affinity_losses(aff: torch.Tensor, bg_label: torch.Tensor, fg_label: torch.Tensor,
                    neg_label: torch.Tensor) -> dict[str, torch.Tensor]:
    """aff: (N, D, P) predicted affinities; the labels have its shape."""
    bg_count = bg_label.sum() + 1e-5
    fg_count = fg_label.sum() + 1e-5
    neg_count = neg_label.sum() + 1e-5
    bg_loss = (-bg_label * torch.log(aff + 1e-5)).sum() / bg_count
    fg_loss = (-fg_label * torch.log(aff + 1e-5)).sum() / fg_count
    neg_loss = (-neg_label * torch.log(1.0 + 1e-5 - aff)).sum() / neg_count
    return {
        "loss": bg_loss / 4 + fg_loss / 4 + neg_loss / 2,
        "bg_loss": bg_loss, "fg_loss": fg_loss, "neg_loss": neg_loss,
        "bg_cnt": bg_count, "fg_cnt": fg_count, "neg_cnt": neg_count,
    }


def make_aff_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        generator: torch.Generator | None = None):
    """Build `step(img (N, 3, H, W), bg, fg, neg) -> metrics`.

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
    labels = label_params(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    model.train()

    def step(img: torch.Tensor, bg_label: torch.Tensor, fg_label: torch.Tensor,
             neg_label: torch.Tensor) -> dict[str, torch.Tensor]:
        metrics = affinity_losses(model(img), bg_label, fg_label, neg_label)
        optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
