"""Exact top-k / bottom-k sums by bit bisection (counterpart of
wseg_tpu/ops/topk.py).

The stage-1 losses reduce large tensors through the top-k: ECR keeps the top
20% of 21*128*128 values per sample, adaptive min pooling the bottom quarter
of the channel max. The k-th order statistic is found exactly by bisecting
the float bits (32 masked counts), and the sum of the top k is one more
masked reduction with the ties at the threshold weighted fractionally, so
exactly k elements count. `torch.topk` would break ties differently.

The float32 bits are mapped to order-preserving signed int32 keys (torch has
no comparison kernels for uint32): non-negative floats keep their bits,
negative ones get `bits ^ 0x7fffffff`. The order is the JAX package's
uint32 order shifted by 2^31, so -0.0 sorts just below +0.0 in both.

Gradient: `g[:, None] * w`, routed to the selected elements, with the tied
ones sharing the remaining weight equally.
"""

from __future__ import annotations

import torch


def _ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys with the float order (and -0.0 < +0.0)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _kth_largest_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """keys (N, M) int32. Per-row key of the k-th largest element (exact),
    bisected bit by bit over the unsigned key space (key + 2^31)."""
    prefix = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for i in range(32):
        cand = prefix | (1 << (31 - i))
        cnt = (keys >= (cand - 2**31).to(torch.int32)[:, None]).sum(dim=1)
        prefix = torch.where(cnt >= k, cand, prefix)
    return (prefix - 2**31).to(torch.int32)


def _topk_weights(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (N, M) float32 -> (N, M) selection weights of the top k: 1 above the
    k-th largest, a fraction on the ties, summing to k per row."""
    keys = _ordered_keys(x)
    thr = _kth_largest_keys(keys, k)[:, None]
    gt = keys > thr
    eq = keys == thr
    n_gt = gt.sum(dim=1)
    n_eq = eq.sum(dim=1)
    tie_w = (k - n_gt).float() / torch.clamp(n_eq, min=1).float()
    return gt.float() + eq.float() * tie_w[:, None]


class _TopkSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int) -> torch.Tensor:
        w = _topk_weights(x, k)
        ctx.save_for_backward(w)
        return (w * x).sum(dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (w,) = ctx.saved_tensors
        return g[:, None] * w, None


def topk_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row sum of the k largest entries of (N, M) -> (N,), in float32.
    Exact."""
    return _TopkSum.apply(x.float(), int(k))


def topk_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean over rows of the per-row top-k means: torch
    `topk(x, k, dim=-1)[0].mean()` for 2-D x."""
    return topk_sum(x, k).mean() / k


def bottomk_relu_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """sum(relu(bottom-k per row)), adaptive min pooling's reduction. The
    selection is made on x (as the bottom k of x are the top k of -x) and
    carries no gradient; relu applies after it."""
    with torch.no_grad():
        w = _topk_weights(-x.detach().float(), k)
    return (w * torch.relu(x.float())).sum()
