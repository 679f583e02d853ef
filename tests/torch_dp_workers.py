"""What the ranks of the data-parallel tests run (tests/test_torch_parallel*.py).

The ranks are fresh processes (wseg_tpu_torch/parallel/launch.py:spawn), so
this module imports torch and the port only: no JAX, and nothing of the
test files or conftest.py. Every function takes the rank's process group
first (None: the one-process run of the same code, or a rank started as
torchrun starts it, which joins the group itself) and the global inputs,
takes the rank's rows itself, and returns plain tensors.
"""

from __future__ import annotations

import contextlib
import hashlib
import io

import numpy as np
import torch

from wseg_tpu_torch.models.layers import BatchNorm2d, Dropout
from wseg_tpu_torch.parallel.mesh import bind, group_for_batch, rank_of, rows_of, size_of


def _rows(group, n: int) -> slice:
    return rows_of(n, rank_of(group), size_of(group))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def bn(group, x, g) -> dict:
    """Train-mode BN of this rank's rows of x (N, C, H, W) and the backward
    of this rank's share sum(out * g) of a loss that sums over the global
    batch: the output rows, the input gradient rows, this rank's shares of
    the weight and bias gradients, and the running statistics."""
    rows = _rows(group, x.shape[0])
    m = BatchNorm2d(x.shape[1], frozen=False, momentum=0.1).train()
    bind(m, group)
    xl = _t(x[rows]).requires_grad_(True)
    out = m(xl)
    (out * _t(g[rows])).sum().backward()
    return dict(out=out.detach(), gx=xl.grad, gw=m.weight.grad, gb=m.bias.grad,
                running_mean=m.running_mean, running_var=m.running_var)


def losses(group, contrast, affinity, seg) -> dict:
    """The three trainers' losses on this rank's rows of global model
    outputs: every metric, and the gradient of the loss with respect to
    each of this rank's output rows."""
    from wseg_tpu_torch.train.affinity import affinity_losses
    from wseg_tpu_torch.train.contrast import contrast_losses
    from wseg_tpu_torch.train.seg import cross_entropy_ignore

    out = {}
    n = contrast["label21"].shape[0]
    rows = _rows(group, n)
    views = [tuple(_t(o[rows]).requires_grad_(True) for o in v)
             for v in (contrast["out1"], contrast["out2"])]
    mets = contrast_losses(*views, _t(contrast["label21"][rows]),
                           tuple(_t(u) for u in contrast["us"]), 0.2,
                           low_res=contrast["low_res"], group=group)
    mets["loss"].backward()
    out["contrast"] = {k: v.detach() for k, v in mets.items()}
    out["contrast_grads"] = [None if t.grad is None else t.grad for t in views[0] + views[1]]

    rows = _rows(group, affinity["aff"].shape[0])
    aff = _t(affinity["aff"][rows]).requires_grad_(True)
    mets = affinity_losses(aff, *(_t(affinity[k][rows]) for k in ("bg", "fg", "neg")),
                           group=group)
    mets["loss"].backward()
    out["affinity"] = {k: v.detach() for k, v in mets.items()}
    out["affinity_grad"] = aff.grad

    rows = _rows(group, seg["logits"].shape[0])
    logits = _t(seg["logits"][rows]).requires_grad_(True)
    loss = cross_entropy_ignore(logits, _t(seg["labels"][rows]), group=group)
    loss.backward()
    out["seg"] = loss.detach()
    out["seg_grad"] = logits.grad
    return out


def pcm_spatial(group, cam, f) -> torch.Tensor:
    """parallel/spatial.py:pcm_spatial on this rank's block of the pixel
    rows of cam (N, HW, C) and f (N, HW, Cf)."""
    from wseg_tpu_torch.parallel.spatial import pcm_spatial as fn

    rows = rows_of(f.shape[1], rank_of(group), size_of(group))
    return fn(_t(cam[:, rows]), _t(f[:, rows]), group)


def gcd_rule(group, batch_size: int) -> dict:
    """group_for_batch on this rank: whether it trains, the training group's
    size, a sum over that group, and what it printed."""
    import torch.distributed as dist

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sub, trains = group_for_batch(batch_size, group)
    total = None
    if trains:
        t = torch.ones(1)
        dist.all_reduce(t, group=sub)
        total = float(t)
    return dict(trains=trains, size=size_of(sub) if trains else 0, total=total,
                printed=buf.getvalue())


def miou(group, predict_dir: str, gt_dir: str, names: list) -> dict:
    """eval/miou.py:do_python_eval over this rank's block of `names`, the
    confusion matrices summed over the group (seg_test's reduction)."""
    from wseg_tpu_torch.eval.miou import do_python_eval
    from wseg_tpu_torch.parallel.mesh import shard_indices

    mine = [names[i] for i in shard_indices(len(names), group)]
    with contextlib.redirect_stdout(io.StringIO()):
        return do_python_eval(predict_dir, gt_dir, mine, group=group)


def torchrun_join(group, batches: list) -> dict:
    """What a CLI does on a rank that torchrun started: resolve the device
    (a bare cuda is the LOCAL_RANK'th card), join the group from the
    environment (parallel/mesh.py:joined, gloo for the CPU), and for each
    global batch size take the training group (group_for_batch) and, on a
    training rank, sum an array over it (all_reduce_array, seg_test's mIoU
    reduction). Returns what it saw, and whether the group was gone after
    the `with` block."""
    import torch.distributed as dist

    from wseg_tpu_torch.parallel.mesh import all_reduce_array, joined
    from wseg_tpu_torch.utils.device import resolve_device

    assert group is None and not dist.is_initialized()
    out = dict(steps=[])
    try:
        out["cuda"] = str(resolve_device("cuda"))
    except RuntimeError as e:  # no card: the message names the one it mapped to
        out["cuda"] = str(e).split(": no CUDA")[0].removeprefix("device ")
    buf = io.StringIO()
    with joined(resolve_device("cpu")) as world, contextlib.redirect_stdout(buf):
        out.update(backend=dist.get_backend(world), rank=rank_of(world), size=size_of(world))
        for batch in batches:
            sub, trains = group_for_batch(batch, world)
            out["steps"].append(dict(trains=trains, size=size_of(sub) if trains else 0,
                                     sum=all_reduce_array(np.array([1.0, rank_of(world)]),
                                                          sub).tolist() if trains else None))
            if not trains:
                break  # a CLI's rank outside the training group ends its run here
    out["printed"] = buf.getvalue()
    out["left"] = not dist.is_initialized()
    return out


def hang(group, seconds: float):
    """Rank 0 waits at a barrier that rank 1 reaches only after `seconds`."""
    import time

    import torch.distributed as dist

    if rank_of(group) == 1:
        time.sleep(seconds)
    dist.barrier(group)


# ---------------------------------------------------------------------------
# one full-width step of each trainer

LOW_RES = 32  # stage 1's second view; the first is 32 too (the JAX dry run's shapes)
GRAD_TARGETS = {
    # tests/test_torch_train.py's targets, by the names each net gives them
    "contrast": ["fc8.weight", "fc_proj.weight", "f9.weight", "f8_3.weight", "f8_4.weight",
                 "b7.conv_branch2a.weight", "b3.conv_branch2a.weight",
                 "b4_2.conv_branch2b1.weight"],
    "affinity": ["f9.weight", "f8_3.weight", "f8_4.weight", "f8_5.weight",
                 "b7.conv_branch2a.weight", "b3.conv_branch2a.weight",
                 "b4_2.conv_branch2b1.weight"],
    "seg": ["cls_conv.weight", "backbone.b7.conv_branch2a.weight",
            "backbone.b3.conv_branch2a.weight", "backbone.b4_2.conv_branch2b1.weight"],
}


def _trainer(kind: str, group, seed: int):
    """(model, step) of one trainer, its weights from `seed`."""
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.affinity import make_aff_train_step
    from wseg_tpu_torch.train.contrast import make_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    init = torch.Generator().manual_seed(seed)
    steps = torch.Generator().manual_seed(seed + 1)
    if kind == "contrast":
        model = build_model("contrast", device="cpu", generator=init)
        opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
        return model, make_train_step(model, opt, 0.2, low_res=LOW_RES, grad_clip=5.0,
                                      generator=steps, group=group)
    if kind == "affinity":
        model = build_model("affinity", device="cpu", generator=init)
        with torch.no_grad():  # affinities in (0.1, 0.5), not 0 (chip_smoke.py:spread_affinities)
            model.f9.weight.mul_(0.01)
        # lr 1e-3: at 1e-2 step 1 drives neg pairs' affinities to ~1, where
        # log(1 + 1e-5 - aff) amplifies the batch-size rounding of the convs
        opt = PolySGD(param_groups(model), 1e-3, 5e-4, 100)
        return model, make_aff_train_step(model, opt, generator=steps, group=group)
    model = generate_net(EXPERIMENTS["SEAM_deeplabv1_resnet38"], device="cpu", generator=init)
    with torch.no_grad():  # a start near ln(21), as tests/test_torch_seg_train.py's
        model.cls_conv.weight.mul_(0.02)
    opt = PolySGD(param_groups(model, seg_label_params(model)), 1e-3, 5e-4, 11, momentum=0.9)
    return model, make_seg_train_step(model, opt, generator=steps, group=group)


def train(group, kind: str, batches, seed: int = 3) -> dict:
    """Two steps of trainer `kind` on this rank's rows of `batches` (a list
    of tuples of global arrays). Returns the metrics of each step, the
    GRAD_TARGETS gradients after step 1, whether every parameter and buffer
    is the same on every rank after step 2, (rank 0) the state_dict after
    step 2, and the names of the frozen parameters."""
    import torch.distributed as dist

    from wseg_tpu_torch.train.optim import label_params, seg_label_params

    model, step = _trainer(kind, group, seed)
    labels = (seg_label_params if kind == "seg" else label_params)(model)
    mets, grads = [], None
    for i, batch in enumerate(batches):
        rows = _rows(group, batch[0].shape[0])
        m = step(*(_t(a[rows]) for a in batch))
        mets.append({k: v.clone() for k, v in m.items()})
        if i == 0:
            named = dict(model.named_parameters())
            grads = {k: named[k].grad.clone() for k in GRAD_TARGETS[kind]}
    same = True
    if group is not None:  # a digest of every parameter's and buffer's bytes
        digest = hashlib.sha256()
        for t in model.state_dict().values():
            digest.update(t.contiguous().numpy())
        digests = [None] * size_of(group)
        dist.all_gather_object(digests, digest.hexdigest(), group=group)
        same = len(set(digests)) == 1
    state = {k: v.clone() for k, v in model.state_dict().items()} if rank_of(group) == 0 \
        else None
    return dict(metrics=mets, grads=grads, same=same, state=state,
                frozen={k for k, v in labels.items() if v == "frozen"})


# ---------------------------------------------------------------------------
# the stage-3 step against the JAX package's mesh


def keep_all(model):
    """Every dropout keeps every unit, scaled by 1 / (1 - rate), as the JAX
    side with `jax.random.bernoulli` patched to all-True."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.forward = (lambda x, s=1.0 / (1.0 - m.rate): x * s)


def seg_steps(group, cfg_kw: dict, weights: str, batches, lr: float, wd: float,
              max_itr: int) -> list:
    """Steps of a DeepLab net (SegConfig(**cfg_kw)) from the state_dict in
    `weights`, dropout keeping all, momentum 0.9, on this rank's rows of
    each batch (x NCHW, labels). Returns (loss, state_dict) a step."""
    from wseg_tpu_torch.seg.config import SegConfig
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    model = generate_net(SegConfig(**cfg_kw), device="cpu")
    model.load_state_dict(torch.load(weights), strict=True)
    keep_all(model)
    opt = PolySGD(param_groups(model, seg_label_params(model)), lr, wd, max_itr + 1,
                  momentum=0.9)
    step = make_seg_train_step(model, opt, group=group)
    out = []
    for x, lab in batches:
        rows = _rows(group, x.shape[0])
        loss = float(step(_t(x[rows]), _t(lab[rows]))["loss"])
        out.append((loss, {k: v.clone() for k, v in model.state_dict().items()}))
    return out


# ---------------------------------------------------------------------------
# the CLIs


def contrast_infer(group, argv: list) -> dict:
    """cli/contrast_infer.py's main on a rank that torchrun started (the CLI
    joins the group itself); returns the names of the cam dicts this rank
    wrote, the (backend, rank, world size) it wrote them in, and whether
    the group was gone when main returned."""
    import torch.distributed as dist

    from wseg_tpu_torch.cli import contrast_infer as entry
    from wseg_tpu_torch.infer import cam

    assert group is None and not dist.is_initialized()
    written, joined, save = [], set(), cam.save_cam_dict

    def record(out_dir, name, *args, **kwargs):
        written.append(name)
        joined.add((dist.get_backend(), dist.get_rank(), dist.get_world_size()))
        return save(out_dir, name, *args, **kwargs)

    cam.save_cam_dict = record
    try:
        entry.main(argv)
    finally:
        cam.save_cam_dict = save
    return dict(written=written, joined=joined, left=not dist.is_initialized())


def cli(group, module: str, argv: list, cwd: str) -> bool:
    """`module.main(argv)` run from `cwd` on a rank that torchrun started
    (the CLI joins the group itself); returns whether the group was gone
    when main returned."""
    import importlib
    import os

    import torch.distributed as dist

    assert group is None and not dist.is_initialized()
    os.chdir(cwd)
    importlib.import_module(module).main(argv)
    return not dist.is_initialized()


def many(group, calls: list) -> list:
    """Several of this module's functions in one spawn: [(name, kwargs), ...]
    -> their results in order."""
    return [globals()[name](group, **kwargs) for name, kwargs in calls]
