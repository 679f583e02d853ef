"""Stage-1 training losses, NCHW at the boundary (counterpart of
wseg_tpu/ops/losses.py; reference contrast_train.py).

* `multilabel_soft_margin_loss` (contrast_train.py:159-160)
* `adaptive_min_pooling_loss` (:16-25)
* `ecr_loss` and its `topk_mean` (:163, 168-172)
* prototype estimation by per-class CAM-confident top-k feature pooling
  (:182-241)
* cross-prototype / cross-pseudo-label InfoNCE (:259-281)
* intra-view InfoNCE with semi-hard prototype mining and per-class hard pixel
  sampling (:283-389), in the JAX package's fixed-shape form: member pixels
  of each class are ranked by a uniform key (the lowest n_c // 2 ranks are a
  uniform sample without replacement) and by similarity to the positive
  prototype (ranks [int(0.6 n_c) - n_c // 2, int(0.6 n_c)) are the
  "lowest-similarity band"); the two selections' weights add up.

Ties are broken as JAX breaks them: the top-k of `estimate_prototypes` and
`intra_view_nce` is a stable descending sort (lower index first, as
`jax.lax.top_k`), and the class ranks a stable argsort. The uniform key of
`intra_view_nce` is an argument, so a caller can feed both packages the same
draw.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wseg_tpu_torch.ops.topk import bottomk_relu_sum, topk_sum


def multilabel_soft_margin_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """mean_n mean_c [-(y log sigmoid(x) + (1-y) log sigmoid(-x))]."""
    loss = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    return loss.mean()


def adaptive_min_pooling_loss(x: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) foreground CAM slice. Per sample: the channel max, then
    the mean of the k = H*W // 4 smallest (relu'd) spatial values."""
    n, _, h, w = x.shape
    k = h * w // 4
    m = x.amax(dim=1).reshape(n, h * w)
    return bottomk_relu_sum(m, k) / (k * n)


def topk_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the k largest entries per row of (N, M), then the mean over
    rows: the ECR reduction (contrast_train.py:170-171)."""
    return topk_sum(x, k).sum() / (k * x.shape[0])


def ecr_loss(cam_other: torch.Tensor, cam_rv: torch.Tensor, frac: float = 0.2) -> torch.Tensor:
    """One half of loss_ecr: the mean of the top 20% of
    |max_onehot(cam_other) - cam_rv|. Inputs (N, C, H, W); `cam_other` must
    already be max_onehot'd and detached."""
    n, c, h, w = cam_rv.shape
    diff = (cam_other - cam_rv).abs().reshape(n, -1)
    return topk_mean(diff, int(c * h * w * frac))


def normalize_cam_for_prototypes(cam_rv_down: torch.Tensor, bg_threshold: float,
                                 e: float = 1e-5) -> torch.Tensor:
    """The detached cam_rv normalization that feeds prototype estimation
    (contrast_train.py:186-194): relu, per-(n, c) spatial min / max, zero the
    entries at the min before shifting (they end slightly negative, as in the
    reference), then channel 0 becomes `bg_threshold`."""
    cam = torch.relu(cam_rv_down)
    mx = cam.amax(dim=(2, 3), keepdim=True)
    mn = cam.amin(dim=(2, 3), keepdim=True)
    cam = torch.where(cam < mn + e, torch.zeros_like(cam), cam)
    cam = (cam - mn - e) / (mx - mn + e)
    return torch.cat([torch.full_like(cam[:, :1], bg_threshold), cam[:, 1:]], dim=1)


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k along the last dim: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def estimate_prototypes(fea: torch.Tensor, norm_cam: torch.Tensor,
                        label: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class CAM-weighted top-k feature pooling (contrast_train.py:195-209).

    fea (N, Cf, H, W) detached projection features; norm_cam (N, C, H, W) from
    `normalize_cam_for_prototypes`; label (N, C) multi-hot with bg.
    Returns (prototypes (C, Cf) L2-normalized, pseudo_label (N*H*W,) int64),
    pixels in (n, h, w) order."""
    n, c, h, w = norm_cam.shape
    cf = fea.shape[1]
    scores = torch.softmax(norm_cam * label[:, :, None, None], dim=1)
    pseudo_label = scores.argmax(dim=1).reshape(-1)

    cam_flat = norm_cam.permute(1, 0, 2, 3).reshape(c, n * h * w)
    fea_flat = fea.permute(0, 2, 3, 1).reshape(n * h * w, cf)
    top_values, top_indices = _top_k_stable(cam_flat, h * w // 8)  # (C, k)
    top_fea = fea_flat[top_indices]  # (C, k, Cf)
    protos = (top_values[..., None] * top_fea).sum(dim=1) / top_values.sum(dim=1, keepdim=True)
    protos = protos / torch.linalg.vector_norm(protos, dim=-1, keepdim=True).clamp_min(1e-12)
    return protos, pseudo_label


def info_nce(f: torch.Tensor, positives: torch.Tensor, negatives: torch.Tensor,
             tau: float = 0.1) -> torch.Tensor:
    """mean(-log(exp(<f, pos>/tau) / sum_c exp(<f, neg_c>/tau)))
    (contrast_train.py:261-267). f, positives (M, Cf); negatives (C, Cf)."""
    a1 = torch.exp((f * positives).sum(dim=-1) / tau)
    a2 = torch.exp(f @ negatives.T / tau).sum(dim=-1)
    return (-torch.log(a1 / a2)).mean()


def intra_view_nce(f: torch.Tensor, prototypes: torch.Tensor, pseudo_label: torch.Tensor,
                   u: torch.Tensor, tau: float = 0.1, num_semi_hard: int = 13,
                   num_drop_top: int = 3, num_classes: int = 21) -> torch.Tensor:
    """Intra-view InfoNCE with semi-hard prototype mining and per-class hard
    pixel sampling (contrast_train.py:283-334), fixed-shape.

    f (M, Cf) L2-normalized projections; prototypes (C, Cf); pseudo_label
    (M,); u (M,) uniform [0, 1) keys that pick each class's random half. The
    denominator is the positive prototype plus the semi-hard negatives: the
    top `num_semi_hard` prototype scores without the top `num_drop_top`."""
    m = f.shape[0]
    pos = prototypes[pseudo_label]  # (M, Cf)
    pos_score = (f * pos).sum(dim=-1)
    sim = (pos_score + 1.0) / 2.0
    a1 = torch.exp(pos_score / tau)

    neg_scores = f @ prototypes.T  # (M, C)
    _, top_idx = _top_k_stable(neg_scores, num_semi_hard)
    lower_scores = torch.gather(neg_scores, 1, top_idx[:, num_drop_top:])
    a2 = torch.exp(pos_score / tau) + torch.exp(lower_scores / tau).sum(dim=-1)
    pixel_loss = -torch.log(a1 / a2)  # (M,)

    onehot = F.one_hot(pseudo_label.long(), num_classes).float()  # (M, C)
    n_c = onehot.sum(dim=0)
    half = torch.floor(n_c / 2.0)
    k60 = torch.floor(n_c * 0.6)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=f.device)
    ramp = torch.arange(m, device=f.device)[:, None].expand(m, num_classes)

    def class_ranks(values: torch.Tensor) -> torch.Tensor:
        """Ascending rank of each pixel within its class, per class column
        (non-members rank after every member)."""
        masked = torch.where(onehot > 0, values[:, None].float(), big)
        order = torch.argsort(masked, dim=0, stable=True)
        return torch.empty_like(order).scatter_(0, order, ramp)

    rand_ranks = class_ranks(u)
    sim_ranks = class_ranks(sim.detach())
    sel_rand = (rand_ranks < half[None, :]).float() * onehot
    in_band = (sim_ranks >= (k60 - half)[None, :]) & (sim_ranks < k60[None, :])
    weights = sel_rand + in_band.float() * onehot  # (M, C), values in {0, 1, 2}

    per_class_sum = (weights * pixel_loss[:, None]).sum(dim=0)
    per_class_cnt = weights.sum(dim=0)
    per_class_loss = torch.where(n_c >= 2, per_class_sum / torch.clamp(per_class_cnt, min=1.0),
                                 torch.zeros_like(per_class_sum))
    num_present = (n_c >= 1).sum()
    return per_class_loss.sum() / torch.clamp(num_present, min=1).float()
