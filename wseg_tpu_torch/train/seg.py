"""Stage-3 DeepLab training step (counterpart of wseg_tpu/train/seg.py;
reference segmentation/experiment/*/train.py:38-144).

Cross-entropy with ignore index 255, then PolySGD with the stage-3 groups
(train/optim.py:seg_label_params). The model runs in train mode: every BN
normalises with the batch statistics and updates its running stats once a
step, and the dropouts (b6/b7 channel dropout on ResNet-38, the head's and
ASPP's element-wise masks) draw from one explicit `torch.Generator`, so a
run is a function of its seed and a resumed run of the generator's state.

Data parallel (a process group, parallel/mesh.py): every BN takes its
moments over the global batch, the dropouts draw at the global shape, the
NLL sum and the valid-pixel count are summed over the ranks, so every rank
computes the identical global loss, and the parameter gradients are
averaged over the ranks, which makes them the one-process gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from wseg_tpu_torch.models.layers import Dropout
from wseg_tpu_torch.parallel.mesh import all_reduce_grads_, all_reduce_sum, bind
from wseg_tpu_torch.train.optim import seg_label_params

IGNORE = 255


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore: int = IGNORE, group=None) -> torch.Tensor:
    """Mean NLL of (N, C, H, W) logits over the pixels whose label is not
    `ignore`, divided by max(valid, 1): 0, not NaN, when every pixel is
    ignored (train/seg.py:26-33). With a process `group` the arguments are
    this rank's rows, and every rank returns the global batch's mean (the
    NLL sum and the valid count summed over the ranks)."""
    labels = labels.long()
    nll = F.cross_entropy(logits.float(), labels, ignore_index=ignore, reduction="sum")
    valid = (labels != ignore).sum()
    if group is not None:
        nll = all_reduce_sum(nll, group)
        dist.all_reduce(valid, group=group)
    return nll / valid.clamp_min(1)


def make_seg_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        generator: torch.Generator | None = None, with_pred: bool = False,
                        group=None):
    """Build `step(img (N, 3, H, W), seg_label (N, H, W)) -> metrics`.

    With a process `group` (parallel/mesh.py) the arguments are this rank's
    rows of the global batch and the step is the one-process step at that
    batch: global-batch BN moments and loss, dropout drawn at the global
    shape, the gradients averaged over the ranks (`pred` is then this
    rank's last sample).

    The step runs the model in train mode, backpropagates the loss and
    applies `optimizer`. BN affine gets no gradient (the optimizer never
    moves it). `generator` (on the model's device; seed 0 by default) drives
    every dropout. Metrics come back as detached device tensors: `loss`,
    and with `with_pred` the uint8 argmax of the last sample (the
    reference's every-100-iterations image, train.py:112-119). Reading them
    syncs.

    On CUDA this turns off TF32 for matmuls and cuDNN convs, process-wide:
    the step is float32, as the JAX one."""
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    bind(model, group)
    labels = seg_label_params(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    model.train()

    def step(img: torch.Tensor, seg_label: torch.Tensor) -> dict[str, torch.Tensor]:
        out = model(img)
        loss = cross_entropy_ignore(out, seg_label, group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(model.parameters(), group)
        optimizer.step()
        metrics = {"loss": loss.detach()}
        if with_pred:
            metrics["pred"] = out[-1].detach().argmax(dim=0).to(torch.uint8)
        return metrics

    return step
