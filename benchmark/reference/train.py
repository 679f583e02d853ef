"""Stage-1 training steps, plain PyTorch: the dual-view forward, the losses and
the reference's SGD (contrast_train.py and tool/torchutils.py of
arXiv:2110.07110's code).

Parameter groups (network/resnet38_contrast.py:77-96): conv1a, b2* and every
BN affine frozen; the heads (fc8, fc_proj, f8_3, f8_4, f9) trained from
scratch at 10x the learning rate; the rest at 1x; weight decay on every
trained weight. The rate is base * (1 - t / max_step) ** power at step t
(from 0). torchutils.py passes the weight decay in SGD's momentum slot, so
the reference trains with momentum equal to the weight decay: buf = m * buf
+ (g + wd * p); p -= lr * buf.
"""

from __future__ import annotations

import torch

from benchmark.reference import contrast_net, losses

FROZEN = ("conv1a", "b2", "b2_1", "b2_2")
SCRATCH = ("fc8", "fc_proj", "f8_3", "f8_4", "f9")


def lr_mult(name: str) -> float:
    """0 for a frozen parameter, else its group's multiplier."""
    mods = name.split(".")[:-1]
    if any(m.startswith("bn") for m in mods) or any(m in FROZEN for m in mods):
        return 0.0
    return 10.0 if any(m in SCRATCH for m in mods) else 1.0


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def draws(generator: torch.Generator, device):
    """The keys of one step, in the order the training forward takes them."""
    def draw(shape):
        return torch.rand(shape, generator=generator, device=device)
    return draw


def steps(params0: dict, batches, cfg: dict, generator: torch.Generator) -> dict:
    """Run len(batches) training steps from `params0` (left unchanged).

    batches: [(img (N, 3, H, W), label (N, 20)), ...] on the device;
    cfg: the configuration's "train" section; generator: the dropout and NCE
    keys, seeded as the measured program's. Returns the loss of each step, its
    classification ("cls") and equivariance ("er") terms, and, per trained
    leaf, the norm of its gradient at the first step and of its change over
    all the steps (float32 tensors on the device)."""
    low_res, bg = cfg["low_res"], cfg["bg_threshold"]
    lr, wd, mom = cfg["lr"], cfg["weight_decay"], cfg["momentum"]
    max_step, power = cfg["max_step"], cfg["poly_power"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    trained = [k for k in p if is_parameter(k) and lr_mult(k) > 0]
    for k in trained:
        p[k].requires_grad_(True)
    buf = {k: torch.zeros_like(p[k]) for k in trained}
    out = {"loss": [], "cls": [], "er": [], "grad": {}, "change": {}}
    for t, (img, label) in enumerate(batches):
        draw = draws(generator, img.device)
        n = img.shape[0]
        label21 = torch.cat([torch.ones_like(label[:, :1]), label.float()], dim=1)
        img2 = contrast_net.up(img, (low_res, low_res))
        out1 = contrast_net.forward(p, img, draw=draw)
        out2 = contrast_net.forward(p, img2, draw=draw)
        us = (draw((n * (low_res // 8) ** 2,)),
              draw((n * out2[2].shape[2] * out2[2].shape[3],)))
        terms = losses.stage1_loss(out1, out2, label21, us, bg, low_res)
        grads = torch.autograd.grad(terms["loss"], [p[k] for k in trained])
        rate = lr * (1.0 - min(t, max_step) / max_step) ** power
        with torch.no_grad():
            for k, g in zip(trained, grads):
                if t == 0:
                    out["grad"][k] = torch.linalg.vector_norm(g)
                buf[k].mul_(mom).add_(g + wd * p[k])
                p[k].sub_(rate * lr_mult(k) * buf[k])
        out["loss"].append(terms["loss"].detach())
        out["cls"].append(terms["cls"].detach())
        out["er"].append(terms["er"].detach())
    with torch.no_grad():
        out["change"] = {k: torch.linalg.vector_norm(p[k] - params0[k]) for k in trained}
    return out
