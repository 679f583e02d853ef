"""Data parallelism over a torch.distributed process group (counterpart of
wseg_tpu/parallel/mesh.py, whose jax Mesh with a `data` axis this replaces).

The rule: W ranks at global batch B compute the one-process step at batch B.
Every rank holds the whole model; rank r takes the contiguous rows
`rows_of(B, r, W)` of each global batch (the JAX package's `shard_batch`
layout). Under GSPMD the JAX package gets the batch-coupled parts for free;
here they are explicit collectives:

* train-mode BN takes its moments over the global batch
  (models/layers.py:BatchNorm2d with a group: one differentiable all_reduce
  of (sum x, sum x^2, count) per layer);
* the losses are the global batch's (train/contrast.py gathers the outputs,
  train/affinity.py and train/seg.py sum their numerators and counts), so
  every rank computes the identical global loss;
* dropout and the intra-view NCE keys are drawn at the global batch's shape
  from the shared generator, and each rank keeps its rows (`bind`);
* the parameter gradients are then averaged over the ranks
  (`all_reduce_grads_`). Each rank's backward of the identical global loss
  gives W times its rows' share (each of the W identical losses sends its
  gradient back through the gathers and all_reduces), so the average is the
  one-process gradient.

NCCL serves the card, gloo the CPU (the CPU tests). `group=None` everywhere
means one process, which runs exactly as without this module.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

# Tensors are flattened into buckets of at most this many elements for the
# gradient all_reduce and the weight broadcast (one collective a bucket).
BUCKET_NUMEL = 1 << 25


def init_from_env(device: torch.device | str) -> dist.ProcessGroup | None:
    """Join the group that torchrun describes (RANK, WORLD_SIZE; LOCAL_RANK
    picks the card, see utils/device.py:resolve_device): NCCL for a CUDA
    `device`, gloo for the CPU. Returns the world group, or None without
    that environment (one process). NCCL failing to initialise raises."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            device_id=device if cuda else None)
    return dist.group.WORLD


@contextlib.contextmanager
def joined(device: torch.device | str):
    """`init_from_env` for the length of a `with` block: yields the group (or
    None) and destroys it on leaving."""
    group = init_from_env(device)
    try:
        yield group
    finally:
        if group is not None:
            dist.destroy_process_group()


def rank_of(group: dist.ProcessGroup | None) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group: dist.ProcessGroup | None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def shard_of(group: dist.ProcessGroup | None) -> tuple[int, int] | None:
    """(rank, world size) of this process in `group`; None without one."""
    return None if group is None else (rank_of(group), size_of(group))


def group_for_batch(batch_size: int, group: dist.ProcessGroup | None
                    ) -> tuple[dist.ProcessGroup | None, bool]:
    """The training group for a global batch of `batch_size`: the first
    gcd(batch_size, W) ranks of `group` (a batch must split into equal rows;
    make_mesh_for_batch's rule). Every rank of `group` calls this. Returns
    (the training group, whether this rank trains); a rank outside it has
    nothing to do, and its run ends at once."""
    if group is None:
        return None, True
    world = size_of(group)
    n = math.gcd(batch_size, world)
    if n == world:
        return group, True
    if rank_of(group) == 0:
        print(f"WARNING: batch_size {batch_size} is not divisible by the {world} ranks -- "
              f"training data-parallel on only {n} rank(s); pick a divisible batch size to "
              "use every rank", flush=True)
    ranks = [dist.get_global_rank(group, r) for r in range(n)]
    sub = dist.new_group(ranks)
    return (sub, True) if rank_of(group) < n else (None, False)


def rows_of(global_batch: int, rank: int, n: int) -> slice:
    """Rank `rank`'s contiguous rows of a global batch split over `n` ranks."""
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split over {n} ranks")
    b = global_batch // n
    return slice(rank * b, (rank + 1) * b)


def shard_indices(n_items: int, group: dist.ProcessGroup | None) -> range:
    """This rank's contiguous block of `n_items` (inference): every item on
    exactly one rank, the blocks' sizes differing by at most one."""
    r, w = rank_of(group), size_of(group)
    return range(r * n_items // w, (r + 1) * n_items // w)


def sync(group: dist.ProcessGroup | None):
    """A barrier of `group`; nothing without one."""
    if group is not None:
        dist.barrier(group)


def all_reduce_array(a, group: dist.ProcessGroup):
    """The sum of a host (numpy) array over the group's ranks, through the
    card for NCCL; returns a numpy array."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(a).to(device).contiguous()
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def _coalesced(tensors: list[torch.Tensor], op):
    """Run `op` in place on flat buckets of `tensors` (grouped by dtype and
    device, at most BUCKET_NUMEL elements a bucket unless one tensor is
    larger) and copy each bucket back into its tensors."""
    kinds: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        kinds.setdefault((t.dtype, t.device), []).append(t)
    for ts in kinds.values():
        start = 0
        while start < len(ts):
            end, numel = start + 1, ts[start].numel()
            while end < len(ts) and numel + ts[end].numel() <= BUCKET_NUMEL:
                numel += ts[end].numel()
                end += 1
            flat = torch.cat([t.reshape(-1) for t in ts[start:end]])
            op(flat)
            offset = 0
            for t in ts[start:end]:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            start = end


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, group: dist.ProcessGroup | None):
    """Every parameter and buffer of `module` from the group's rank 0 to the
    others (the counterpart of `replicate`)."""
    if group is None:
        return
    _coalesced(list(module.parameters()) + list(module.buffers()),
               lambda flat: dist.broadcast(flat, group=group, group_src=0))


@torch.no_grad()
def all_reduce_grads_(params, group: dist.ProcessGroup | None):
    """Average the gradients of `params` over the group, in place (see the
    module docstring for why the average is the one-process gradient)."""
    if group is None:
        return
    w = size_of(group)

    def average(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(w)

    _coalesced([p.grad for p in params if p.grad is not None], average)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank's output is the sum of every rank's input
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.start, ctx.length = rank_of(group) * x.shape[dim], x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size_of(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        # reduce over the ranks, then keep this rank's rows (a reduce-scatter)
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.length), None, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable: the gradient of
    each rank's input is the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order (every rank the
    same length there), differentiable: the backward sums the output
    gradients over the ranks and keeps this rank's rows."""
    return _AllGatherRows.apply(x, group, dim)


def bind(model: torch.nn.Module, group: dist.ProcessGroup | None):
    """Point `model`'s batch-statistics BNs at `group` (global-batch moments)
    and make its dropouts draw at the global batch's shape and keep this
    rank's rows; `group=None` undoes both."""
    from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout

    shard = shard_of(group)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
        elif isinstance(m, Dropout):
            m.shard = shard
