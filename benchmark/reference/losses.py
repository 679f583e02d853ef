"""The stage-1 losses, plain PyTorch (contrast_train.py:126-392 of
arXiv:2110.07110's code, in the fixed-shape form of its intra-view NCE).

SEAM's terms (classification, adaptive min pooling of the refined CAM, the
equivariance and equivariant-cross regularisers) on the crop and its
low_res x low_res downscale, prototypes by CAM-weighted top-k pooling, and
three InfoNCE terms. Where the selection matters for ties (the prototypes'
top-k, the class ranks), the order is a stable sort: lower index first. The
intra-view term's random half of each class is chosen by the uniform keys
`us`, handed in, so the measured program and this reference see one draw.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.contrast_net import up


def max_norm(p, e: float = 1e-5):
    p = torch.relu(p)
    hi = p.amax(dim=(2, 3), keepdim=True)
    lo = p.amin(dim=(2, 3), keepdim=True)
    return torch.relu(p - lo - e) / (hi - lo + e)


def max_onehot(x):
    fg = x[:, 1:]
    fg = torch.where(fg < fg.amax(dim=1, keepdim=True), torch.zeros_like(fg), fg)
    return torch.cat([x[:, :1], fg], dim=1)


def soft_margin(logits, targets):
    return (-(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))).mean()


def min_pooling(x):
    """Per sample: the mean of relu over the quarter of pixels whose channel
    max is lowest; the mean over samples."""
    n, _, h, w = x.shape
    k = h * w // 4
    m = x.amax(dim=1).reshape(n, h * w)
    idx = torch.topk(-m.detach(), k, dim=1).indices
    return torch.relu(torch.gather(m, 1, idx)).sum() / (k * n)


def ecr(cam_other, cam_rv, frac: float = 0.2):
    n, c, h, w = cam_rv.shape
    k = int(c * h * w * frac)
    diff = (cam_other - cam_rv).abs().reshape(n, -1)
    return torch.topk(diff, k, dim=1).values.sum() / (k * n)


def _top_k_stable(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cam_for_prototypes(cam_rv_down, bg_threshold, e: float = 1e-5):
    cam = torch.relu(cam_rv_down)
    hi = cam.amax(dim=(2, 3), keepdim=True)
    lo = cam.amin(dim=(2, 3), keepdim=True)
    cam = torch.where(cam < lo + e, torch.zeros_like(cam), cam)
    cam = (cam - lo - e) / (hi - lo + e)
    return torch.cat([torch.full_like(cam[:, :1], bg_threshold), cam[:, 1:]], dim=1)


def prototypes(fea, norm_cam, label):
    """(C, Cf) L2-normalised prototypes and the (N*H*W,) pseudo-labels."""
    n, c, h, w = norm_cam.shape
    cf = fea.shape[1]
    pseudo = torch.softmax(norm_cam * label[:, :, None, None], dim=1).argmax(dim=1).reshape(-1)
    cam_flat = norm_cam.permute(1, 0, 2, 3).reshape(c, n * h * w)
    fea_flat = fea.permute(0, 2, 3, 1).reshape(n * h * w, cf)
    vals, idx = _top_k_stable(cam_flat, h * w // 8)
    protos = (vals[..., None] * fea_flat[idx]).sum(dim=1) / vals.sum(dim=1, keepdim=True)
    return F.normalize(protos, dim=-1), pseudo


def info_nce(f, positives, negatives, tau: float = 0.1):
    a1 = torch.exp((f * positives).sum(dim=-1) / tau)
    a2 = torch.exp(f @ negatives.T / tau).sum(dim=-1)
    return (-torch.log(a1 / a2)).mean()


def intra_nce(f, protos, pseudo, u, tau: float = 0.1, semi_hard: int = 13, drop_top: int = 3,
              num_classes: int = 21):
    """Per class: the mean pixel loss over a random half of its pixels (the
    lowest keys u) plus the band of ranks [int(0.6 n) - n // 2, int(0.6 n)) by
    similarity to the positive prototype; the mean over present classes."""
    m = f.shape[0]
    pos_score = (f * protos[pseudo]).sum(dim=-1)
    neg = f @ protos.T
    _, top = _top_k_stable(neg, semi_hard)
    lower = torch.gather(neg, 1, top[:, drop_top:])
    pixel = -torch.log(torch.exp(pos_score / tau)
                       / (torch.exp(pos_score / tau) + torch.exp(lower / tau).sum(dim=-1)))
    onehot = F.one_hot(pseudo, num_classes).float()
    n_c = onehot.sum(dim=0)
    half, k60 = torch.floor(n_c / 2), torch.floor(n_c * 0.6)
    ramp = torch.arange(m, device=f.device)[:, None].expand(m, num_classes)

    def ranks(values):
        masked = torch.where(onehot > 0, values[:, None].float(),
                             torch.full_like(onehot, 3.4e38))
        order = torch.argsort(masked, dim=0, stable=True)
        return torch.empty_like(order).scatter_(0, order, ramp)

    sel = (ranks(u) < half).float() * onehot
    sim_r = ranks(((pos_score + 1) / 2).detach())
    band = ((sim_r >= k60 - half) & (sim_r < k60)).float() * onehot
    weights = sel + band
    per_class = (weights * pixel[:, None]).sum(dim=0) / weights.sum(dim=0).clamp_min(1)
    per_class = torch.where(n_c >= 2, per_class, torch.zeros_like(per_class))
    return per_class.sum() / (n_c >= 1).sum().clamp_min(1).float()


def stage1_loss(out1, out2, label21, us, bg_threshold: float, low_res: int) -> dict:
    """The stage-1 losses of the crop's and the downscale's outputs (cam,
    cam_rv, f_proj, cam_rv_down); label21 (N, 21) with background 1:
    {"loss": the total, "cls": classification and min pooling, "er": the
    equivariance term}. Those two select nothing whose value jumps when a
    rounding flips the choice (a top-k's sum does not); the equivariant-cross
    term's max_onehot and the InfoNCE terms' argmax, top-k and rank bands do."""
    cam1, cam_rv1, f_proj1, cam_rv1_down = out1
    cam2, cam_rv2, f_proj2, cam_rv2_down = out2
    lbl = label21[:, :, None, None]
    low = (low_res, low_res)

    loss_cls = (soft_margin(cam1.mean(dim=(2, 3))[:, 1:], label21[:, 1:])
                + soft_margin(cam2.mean(dim=(2, 3))[:, 1:], label21[:, 1:])) / 2
    loss_cls = loss_cls + (min_pooling((cam_rv1 * lbl)[:, 1:])
                           + min_pooling((cam_rv2 * lbl)[:, 1:])) / 2
    cam1n = up(max_norm(cam1), low) * lbl
    cam_rv1n = up(max_norm(cam_rv1), low) * lbl
    cam2n = max_norm(cam2) * lbl
    cam_rv2n = max_norm(cam_rv2) * lbl
    loss_er = (cam1n[:, 1:] - cam2n[:, 1:]).abs().mean()

    def bg(c):
        return torch.cat([1.0 - c[:, 1:].amax(dim=1, keepdim=True), c[:, 1:]], dim=1)

    cam1n, cam2n = bg(cam1n), bg(cam2n)
    loss_ecr = (ecr(max_onehot(cam2n.detach()), cam_rv1n)
                + ecr(max_onehot(cam1n.detach()), cam_rv2n))

    ds = (low_res // 8, low_res // 8)
    f_proj1 = up(f_proj1, ds)
    cam_rv1_down = up(cam_rv1_down, ds)
    protos1, pl1 = prototypes(f_proj1.detach(),
                              cam_for_prototypes(cam_rv1_down.detach(), bg_threshold), label21)
    protos2, pl2 = prototypes(f_proj2.detach(),
                              cam_for_prototypes(cam_rv2_down.detach(), bg_threshold), label21)
    cf = f_proj1.shape[1]
    f1 = F.normalize(f_proj1.permute(0, 2, 3, 1).reshape(-1, cf), dim=-1)
    f2 = F.normalize(f_proj2.permute(0, 2, 3, 1).reshape(-1, cf), dim=-1)
    loss_nce = 0.1 * (info_nce(f1, protos2[pl1], protos2) + info_nce(f2, protos1[pl2], protos1)) / 2
    loss_nce = loss_nce + 0.1 * (info_nce(f1, protos1[pl2], protos1)
                                 + info_nce(f2, protos2[pl1], protos2)) / 2
    loss_nce = loss_nce + 0.1 * (intra_nce(f1, protos1, pl1, us[0])
                                 + intra_nce(f2, protos2, pl2, us[1])) / 2
    return {"loss": loss_cls + loss_er + loss_ecr + loss_nce, "cls": loss_cls, "er": loss_er}
