"""Stage-3 DeepLab v1 (LargeFOV) on ResNet-38, trained, as plain PyTorch
functions of a state_dict.

A frozen copy of the step the benchmark measures, written from the published
description: DeepLab-LargeFOV (Chen et al., arXiv:1412.7062: fc6 as a 3x3
conv at dilation 12, then a 1x1 fc7 and the classifier) on the WideResNet-38
trunk (Wu et al., arXiv:1611.10080), as SEAM's stage 3 trains it (Wang et
al., arXiv:2004.04581) in the code of Du et al. (arXiv:2110.07110):
segmentation/lib/net/deeplabv1.py, lib/net/backbone/resnet38d.py and
experiment/SEAM_deeplabv1_resnet38/{config,train}.py.

- The trunk of `contrast_net` (the same blocks, strides, dilations and
  channel dropouts), every BatchNorm normalising with the batch's
  statistics (biased variance) and moving its running statistics at the
  trunk's module constant momentum 3e-4 (resnet38d.py:8) with the unbiased
  variance, as torch's BatchNorm2d in train mode does: the training script
  never calls `net.train()` on the trunk, so its BN-freeze is dead code.
- The head: `conv_fov` 3x3 at dilation 12, 4096 -> 512, BN, relu;
  `conv_fov2` 1x1, 512 -> 512, BN, relu (the head's BNs at TRAIN_BN_MOM,
  3e-4 in the preset); element-wise dropout 0.5; `cls_conv` 1x1 with bias,
  512 -> 21; the logits upsampled bilinearly to the input, align_corners
  True.
- The loss: cross-entropy over the pixels whose label is not 255, summed and
  divided by max(valid, 1).
- SGD (torch's, momentum 0.9, weight decay 5e-4): the backbone's conv
  weights at the base rate with decay, the head's conv weights at 10x with
  decay, `cls_conv`'s bias at 20x without; BN affine in no group, so
  frozen. The rate is base * (1 - t / (max_itr + 1)) ** 0.9 at step t from
  0 (train.py's adjust_lr).

Departures: the head is 512 wide, as deeplabv1.py has it, not the paper's
1024; dropout draws its masks from `draw(shape)` in the order the modules
run (keep where u >= rate), where torch's modules draw from the global
stream, so the program under test and this copy drop the same units; the
weights are random from a seed, not ImageNet's or stage 1's. Nothing here
imports the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.contrast_net import (
    BASIC, BN_EPS, BOTTLENECK, RESIDUAL_SCALE, _conv, _dropout2d, up,
)

NUM_CLASSES = 21
HEAD_DIM = 512
FOV_DILATION = 12
TRUNK_BN_MOM = 3e-4
IGNORE = 255
HEAD = ("conv_fov", "conv_fov2", "cls_conv")


def param_specs() -> list[tuple[str, tuple, str, float]]:
    """Every state_dict entry of the net as (name, shape, kind, std), in the
    `weights.make` form: He-normal convs, each residual branch's last conv at
    RESIDUAL_SCALE of He's std, zero biases, identity BN."""
    specs = []

    def conv(name, cin, cout, k, scale=1.0):
        specs.append((f"{name}.weight", (cout, cin, k, k), "normal",
                      math.sqrt(2.0 / (cin * k * k)) * scale))

    def bn(name, c):
        for leaf, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            specs.append((f"{name}.{leaf}", (c,), "const", value))

    conv("backbone.conv1a", 3, 64, 3)
    for name, cin, mid, cout, stride, _, _ in BASIC:
        b = f"backbone.{name}"
        bn(f"{b}.bn_branch2a", cin)
        if cin != cout or stride != 1:
            conv(f"{b}.conv_branch1", cin, cout, 1)
        conv(f"{b}.conv_branch2a", cin, mid, 3)
        bn(f"{b}.bn_branch2b1", mid)
        conv(f"{b}.conv_branch2b1", mid, cout, 3, scale=RESIDUAL_SCALE)
    for name, cin, cout, _, _ in BOTTLENECK:
        b = f"backbone.{name}"
        bn(f"{b}.bn_branch2a", cin)
        conv(f"{b}.conv_branch1", cin, cout, 1)
        conv(f"{b}.conv_branch2a", cin, cout // 4, 1)
        bn(f"{b}.bn_branch2b1", cout // 4)
        conv(f"{b}.conv_branch2b1", cout // 4, cout // 2, 3)
        bn(f"{b}.bn_branch2b2", cout // 2)
        conv(f"{b}.conv_branch2b2", cout // 2, cout, 1, scale=RESIDUAL_SCALE)
    bn("backbone.bn7", 4096)
    conv("cls_conv", HEAD_DIM, NUM_CLASSES, 1)
    specs.append(("cls_conv.bias", (NUM_CLASSES,), "const", 0.0))
    conv("conv_fov", 4096, HEAD_DIM, 3)
    bn("bn_fov", HEAD_DIM)
    conv("conv_fov2", HEAD_DIM, HEAD_DIM, 1)
    bn("bn_fov2", HEAD_DIM)
    return specs


def _bn(p, name, x, momentum, running):
    """Batch-statistics BN; the new running statistics go into `running`."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean = x.mean(dim=(0, 2, 3))
    var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    with torch.no_grad():
        running[f"{name}.running_mean"] = ((1 - momentum) * p[f"{name}.running_mean"]
                                           + momentum * mean)
        running[f"{name}.running_var"] = ((1 - momentum) * p[f"{name}.running_var"]
                                          + momentum * var * n / max(n - 1, 1))
    scale = p[f"{name}.weight"] * torch.rsqrt(var + BN_EPS)
    shift = p[f"{name}.bias"] - mean * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _dropout(x, rate, draw):
    """Element-wise dropout with an explicit key: keep where u >= rate."""
    u = draw(tuple(x.shape))
    return x * ((u >= rate).to(x.dtype) / (1.0 - rate))


def trunk(p, x, draw, running):
    """conv6 = relu(bn7(b7)) of the stride-8 trunk in train mode."""
    def bn(name, v):
        return torch.relu(_bn(p, f"backbone.{name}", v, TRUNK_BN_MOM, running))

    def conv(name, v, stride=1, dilation=1):
        return _conv(p, f"backbone.{name}", v, stride, dilation)

    x = conv("conv1a", x)
    for name, cin, _, cout, stride, fd, dil in BASIC:
        a = bn(f"{name}.bn_branch2a", x)
        branch1 = x if cin == cout and stride == 1 else conv(f"{name}.conv_branch1", a, stride)
        b = bn(f"{name}.bn_branch2b1", conv(f"{name}.conv_branch2a", a, stride, fd))
        x = branch1 + conv(f"{name}.conv_branch2b1", b, 1, dil)
    for name, _, _, dil, rate in BOTTLENECK:
        a = bn(f"{name}.bn_branch2a", x)
        branch1 = conv(f"{name}.conv_branch1", a)
        b = bn(f"{name}.bn_branch2b1", conv(f"{name}.conv_branch2a", a))
        b = bn(f"{name}.bn_branch2b2",
               conv(f"{name}.conv_branch2b1", _dropout2d(b, rate, draw), 1, dil))
        x = branch1 + conv(f"{name}.conv_branch2b2", _dropout2d(b, rate, draw))
    return bn("bn7", x)


def forward(p, x, draw, running, bn_mom: float = TRUNK_BN_MOM):
    """Logits (N, 21, H, W) of x (N, 3, H, W) in train mode; `running`
    receives every BN's new running statistics; `bn_mom` is the head's BN
    momentum."""
    f = trunk(p, x, draw, running)
    f = torch.relu(_bn(p, "bn_fov", _conv(p, "conv_fov", f, 1, FOV_DILATION), bn_mom, running))
    f = torch.relu(_bn(p, "bn_fov2", _conv(p, "conv_fov2", f), bn_mom, running))
    f = _dropout(f, 0.5, draw)
    logits = F.conv2d(f, p["cls_conv.weight"], p["cls_conv.bias"])
    return up(logits, x.shape[-2:])


def loss(logits, label):
    """Mean NLL over the pixels whose label is not IGNORE, divided by
    max(valid, 1)."""
    valid = label != IGNORE
    target = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -torch.log_softmax(logits, dim=1).gather(1, target[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def lr_mult(name: str) -> float:
    """0 for a frozen parameter (BN affine, the running statistics), else its
    group's multiplier."""
    mod = name.split(".")[-2]
    if mod.startswith("bn") or name.endswith(("running_mean", "running_var")):
        return 0.0
    if name.split(".")[0] in HEAD:
        return 20.0 if name.endswith("bias") else 10.0
    return 1.0


def decays(name: str) -> bool:
    return name.endswith("weight")


def draws(generator: torch.Generator, device):
    def draw(shape):
        return torch.rand(shape, generator=generator, device=device)
    return draw


def steps(params0: dict, batches, cfg: dict, generator: torch.Generator) -> dict:
    """Run len(batches) training steps from `params0` (left unchanged).

    batches: [(img (N, 3, H, W), label (N, H, W)), ...] on the device; cfg:
    the configuration's "train" section (lr, momentum, weight_decay,
    poly_power, max_itr, bn_mom); generator: the dropout keys, seeded as the
    measured program's. Returns each step's loss ("loss"), every trained
    leaf's gradient at the first step ("grad") and the state after the
    last step ("params": every entry of params0, running statistics
    included)."""
    lr, wd, mom = cfg["lr"], cfg["weight_decay"], cfg["momentum"]
    max_step, power = cfg["max_itr"] + 1, cfg["poly_power"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    trained = [k for k in p if lr_mult(k) > 0]
    for k in trained:
        p[k].requires_grad_(True)
    buf = {k: torch.zeros_like(p[k]) for k in trained}
    out = {"loss": [], "grad": {}}
    for t, (img, label) in enumerate(batches):
        running = {}
        terms = loss(forward(p, img, draws(generator, img.device), running, cfg["bn_mom"]),
                     label)
        grads = torch.autograd.grad(terms, [p[k] for k in trained])
        rate = lr * (1.0 - min(t, max_step) / max_step) ** power
        with torch.no_grad():
            for k, g in zip(trained, grads):
                if t == 0:
                    out["grad"][k] = g
                buf[k].mul_(mom).add_(g + wd * p[k] if decays(k) else g)
                p[k].sub_(rate * lr_mult(k) * buf[k])
            p.update(running)
        out["loss"].append(terms.detach())
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
