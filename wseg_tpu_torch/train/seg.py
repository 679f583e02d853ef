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

`build_seg_trainer` makes what `cli/seg_train.py` trains with from a
`SegConfig`: the net, the optimizer, the dropout generator, the step and
the card's cuDNN mode. Under a recording `torch.profiler` the step opens
the ranges `wseg.seg.step` > `seg.forward` (> `seg.backbone`, `seg.head`,
seg/deeplab.py), `seg.loss`, `seg.backward`, `seg.optimizer`
(utils/profiling.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from wseg_tpu_torch.models.layers import Dropout
from wseg_tpu_torch.parallel.mesh import all_reduce_grads_, all_reduce_sum, bind
from wseg_tpu_torch.seg.deeplab import generate_net
from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
from wseg_tpu_torch.utils.profiling import span

IGNORE = 255
# cuDNN autotunes each conv shape once, trying its heuristic's first 3
# algorithms (torch.backends.cudnn.benchmark_limit; torch's default is 10).
# v1 / ResNet-38, crop 448, batch 10, f32 on an H100 (PERF.md): the
# first step took 244 s with every algorithm tried (b7's dilation-4 backward
# 50 s of it, conv_fov's 42 s) for a 734 ms step, 17.4 s with 3 for 736 ms;
# the heuristic's choice (no autotuning) runs the step in 848 ms.
CUDNN_BENCHMARK_LIMIT = 3


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
        with span("seg.step"):
            with span("seg.forward"):
                out = model(img)
            with span("seg.loss"):
                loss = cross_entropy_ignore(out, seg_label, group=group)
            with span("seg.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                all_reduce_grads_(model.parameters(), group)
            with span("seg.optimizer"):
                optimizer.step()
            metrics = {"loss": loss.detach()}
            if with_pred:
                metrics["pred"] = out[-1].detach().argmax(dim=0).to(torch.uint8)
            return metrics

    return step


@dataclass
class SegTrainer:
    """What `build_seg_trainer` makes; `step(img, seg_label) -> metrics` is
    `make_seg_train_step`'s over the other three."""
    model: torch.nn.Module
    optimizer: PolySGD
    generator: torch.Generator
    step: Callable


def build_seg_trainer(cfg, device: torch.device, seed: int, group=None) -> SegTrainer:
    """seg_train's training objects from `cfg` (seg/config.py:SegConfig):
    the net of MODEL_NAME on MODEL_BACKBONE, initialised from `seed` on the
    host (seg/deeplab.py:generate_net); PolySGD over the stage-3 groups at
    TRAIN_LR, TRAIN_WEIGHT_DECAY and TRAIN_MOMENTUM, decaying over
    TRAIN_ITERATION + 1 steps as the reference's lr rule does; the dropout
    generator on `device`, seeded with `seed`; and the step, with the last
    sample's prediction when TRAIN_TBLOG is set. On CUDA the step is strict
    float32 (TF32 off) and cuDNN autotunes each conv shape at its first call
    among CUDNN_BENCHMARK_LIMIT algorithms (process-wide settings). Weights
    loaded into the model afterwards, in place, train as these did."""
    model = generate_net(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    optimizer = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                        cfg.TRAIN_WEIGHT_DECAY, cfg.TRAIN_ITERATION + 1, power=cfg.TRAIN_POWER,
                        momentum=cfg.TRAIN_MOMENTUM)
    generator = torch.Generator(device=device).manual_seed(seed)
    step = make_seg_train_step(model, optimizer, generator=generator,
                               with_pred=cfg.TRAIN_TBLOG, group=group)
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.benchmark_limit = CUDNN_BENCHMARK_LIMIT
    return SegTrainer(model, optimizer, generator, step)
