"""Poly-decay SGD and Adam with per-parameter-group lr multipliers and weight
decay (counterpart of wseg_tpu/train/optim.py; reference
tool/torchutils.py:11-58 and the 4-way grouping of
network/resnet38_contrast.py:77-96):

  pretrained_w  pretrained conv weights     lr x1,  weight decay
  pretrained_b  pretrained conv biases      lr x2
  scratch_w     from-scratch conv weights   lr x10, weight decay
  scratch_b     from-scratch conv biases    lr x20
  frozen        conv1a / b2* convs and every BN affine (resnet38d.py:192-214):
                no update at all

Stage 3 labels its parameters otherwise (`seg_label_params`): every conv of
the backbone is pretrained, conv1a and b2* included, the head's convs are
scratch, and only BN affine is frozen.

lr schedule: base_lr * (1 - min(step, max_step) / max_step) ** power, step
counted from 0 (torchutils.py:25-29).

The reference builds `torch.optim.SGD(params, lr, weight_decay)` with
weight_decay in SGD's positional momentum slot (torchutils.py:14), so it
trained with momentum 5e-4; that is the default here. Update order, as
torch's: d = g + wd * p; buf = momentum * buf + d; p -= lr_group * buf.
"""

from __future__ import annotations

import torch
from torch import nn

from wseg_tpu_torch.models.layers import BatchNorm2d

# label -> (lr multiplier, uses weight decay)
GROUP_SPECS = {
    "pretrained_w": (1.0, True),
    "pretrained_b": (2.0, False),
    "scratch_w": (10.0, True),
    "scratch_b": (20.0, False),
    "frozen": (0.0, False),
}

# stage-1 heads trained from scratch (resnet38_contrast.py:28, resnet38_aff.py:27)
SCRATCH_MODULES = ("fc8", "fc_proj", "f8_3", "f8_4", "f8_5", "f9")
# modules frozen by the reference's `not_training` list (resnet38_contrast.py:29)
FROZEN_MODULES = ("conv1a", "b2", "b2_1", "b2_2")


def label_params(model: nn.Module) -> dict[str, str]:
    """Group label of every parameter, keyed by its `named_parameters()` name."""
    labels = {}
    for name, _ in model.named_parameters():
        *mods, leaf = name.split(".")
        if any(m.startswith("bn") or m.startswith("dropout") for m in mods):
            labels[name] = "frozen"  # frozen BN affine
        elif any(m in FROZEN_MODULES for m in mods):
            labels[name] = "frozen"
        elif any(m in SCRATCH_MODULES for m in mods):
            labels[name] = "scratch_b" if leaf == "bias" else "scratch_w"
        else:
            labels[name] = "pretrained_b" if leaf == "bias" else "pretrained_w"
    return labels


def seg_label_params(model: nn.Module) -> dict[str, str]:
    """Stage-3 group labels (seg_param_labels, wseg_tpu/seg/deeplab.py:349-377;
    the reference's get_parameter_groups, deeplabv1.py:53-69): conv weights
    and biases only. A parameter of a BatchNorm is frozen: the JAX package
    tests whether any module name on the path contains "bn", which names
    exactly its BNs; the port's Sequential BNs (`conv1.1`, `downsample.1`,
    `aspp.branch1.1`) carry an index, so it tests the module's type. Every
    other backbone parameter is pretrained, the head's are scratch."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(mod, BatchNorm2d):
                labels[name] = "frozen"
                continue
            kind = "pretrained" if mod_name.startswith("backbone.") else "scratch"
            labels[name] = f"{kind}_{'b' if leaf == 'bias' else 'w'}"
    return labels


def param_groups(model: nn.Module, labels: dict[str, str] | None = None) -> list[dict]:
    """One optimizer group per non-empty label (`labels`, by default stage
    1-2's `label_params`), with its lr multiplier and weight-decay switch.
    The frozen group is kept (its multiplier is 0), so a state_dict covers
    every parameter."""
    labels = label_params(model) if labels is None else labels
    groups = []
    for label, (mult, use_wd) in GROUP_SPECS.items():
        params = [p for n, p in model.named_parameters() if labels[n] == label]
        if params:
            groups.append({"params": params, "label": label, "lr_mult": mult, "use_wd": use_wd})
    return groups


class _Poly(torch.optim.Optimizer):
    """Shared poly schedule; the step count lives in every group (one value)."""

    def __init__(self, groups, base_lr: float, weight_decay: float, max_step: int,
                 power: float, **defaults):
        super().__init__(groups, dict(lr_mult=1.0, use_wd=True, step=0, **defaults))
        self.base_lr, self.weight_decay = base_lr, weight_decay
        self.max_step, self.power = max_step, power

    @property
    def step_count(self) -> int:
        return self.param_groups[0]["step"]

    def current_lr(self) -> float:
        frac = min(self.step_count, self.max_step) / self.max_step
        return self.base_lr * (1.0 - frac) ** self.power

    def _updates(self):
        """(group, lr_group, wd, params with grads) of every trained group."""
        lr_t = self.current_lr()
        for group in self.param_groups:
            group["step"] += 1
            if group["lr_mult"] == 0.0:
                continue
            wd = self.weight_decay if group["use_wd"] else 0.0
            yield group, lr_t * group["lr_mult"], wd, [p for p in group["params"]
                                                      if p.grad is not None]


class PolySGD(_Poly):
    def __init__(self, groups, base_lr: float, weight_decay: float, max_step: int,
                 power: float = 0.9, momentum: float = 5e-4):
        super().__init__(groups, base_lr, weight_decay, max_step, power, momentum=momentum)

    @torch.no_grad()
    def step(self, closure=None):
        for group, lr, wd, params in self._updates():
            for p in params:
                d = p.grad.add(p, alpha=wd) if wd else p.grad
                state = self.state[p]
                if "momentum_buf" not in state:
                    state["momentum_buf"] = torch.zeros_like(p)
                buf = state["momentum_buf"]
                buf.mul_(group["momentum"]).add_(d)
                p.add_(buf, alpha=-lr)


class PolyAdam(_Poly):
    """Poly-decayed Adam with the same groups; weight decay is L2 added to the
    gradient, as torch Adam's (tool/torchutils.py:36-58)."""

    def __init__(self, groups, base_lr: float, weight_decay: float, max_step: int,
                 power: float = 0.9, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(groups, base_lr, weight_decay, max_step, power, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        for group, lr, wd, params in self._updates():
            b1, b2 = group["betas"]
            t = group["step"]
            for p in params:
                d = p.grad.add(p, alpha=wd) if wd else p.grad
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_((1 - b1) * d)
                nu.mul_(b2).add_((1 - b2) * d * d)
                mu_hat = mu / (1 - b1 ** t)
                nu_hat = nu / (1 - b2 ** t)
                p.sub_(lr * mu_hat / (torch.sqrt(nu_hat) + group["eps"]))
