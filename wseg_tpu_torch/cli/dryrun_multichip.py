"""The multi-process dry run (twin of __graft_entry__.dryrun_multichip): one
full-width train step of each of the three trainers on n gloo CPU ranks.

    python -m wseg_tpu_torch.cli.dryrun_multichip --n 8

The ranks are fresh processes joined over a file store in a temporary
directory (parallel/launch.py). Each trainer runs one step at global batch
n, one sample a rank, at the JAX dry run's tiny shapes (stage 1 at crop 32
with a crop-32 second view, stages 2 and 3 at crop 48: the smallest
AffinityNet map with pairs). It asserts that every loss is finite and the
same on every rank, and that the stage-3 BN running statistics moved and
are equal on every rank (the global-batch BN of the data-parallel step).
Prints one line per stage and `dryrun_multichip(n) OK: ...` last.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def _stage1(group, n: int) -> float:
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.parallel.mesh import rank_of, rows_of
    from wseg_tpu_torch.train.contrast import make_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups

    crop, rows = 32, rows_of(n, rank_of(group), n)
    model = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(0))
    opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
    img = np.random.RandomState(0).rand(n, 3, crop, crop).astype(np.float32)
    label = (np.random.RandomState(1).rand(n, 20) > 0.7).astype(np.float32)
    step = make_train_step(model, opt, low_res=crop, group=group)
    return float(step(torch.from_numpy(img[rows]), torch.from_numpy(label[rows]))["loss"])


def _stage2(group, n: int) -> float:
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.models.affinity import clamped_radius
    from wseg_tpu_torch.ops.pairs import radius_pair_indices, search_offsets
    from wseg_tpu_torch.parallel.mesh import rank_of, rows_of
    from wseg_tpu_torch.train.affinity import make_aff_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups

    crop, rows = 48, rows_of(n, rank_of(group), n)
    model = build_model("affinity", device="cpu", generator=torch.Generator().manual_seed(0))
    h8 = crop // 8
    radius = clamped_radius(h8, h8, model.radius)
    d = len(search_offsets(radius))
    p = radius_pair_indices(radius, (h8, h8))[0].shape[0]
    opt = PolySGD(param_groups(model), 0.1, 1e-4, 100)
    rs = np.random.RandomState(2)
    img = rs.rand(n, 3, crop, crop).astype(np.float32)
    bg, fg, neg = ((rs.rand(n, d, p) > 0.5).astype(np.float32) for _ in range(3))
    step = make_aff_train_step(model, opt, group=group)
    return float(step(*(torch.from_numpy(a[rows]) for a in (img, bg, fg, neg)))["loss"])


def _stage3(group, n: int) -> tuple[float, dict, float]:
    from wseg_tpu_torch.parallel.mesh import rank_of, rows_of
    from wseg_tpu_torch.seg.config import SegConfig
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    crop, rows = 48, rows_of(n, rank_of(group), n)
    model = generate_net(SegConfig(TRAIN_BN_MOM=0.01), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    opt = PolySGD(param_groups(model, seg_label_params(model)), 0.001, 5e-4, 100, momentum=0.9)
    rs = np.random.RandomState(3)
    img = rs.rand(n, 3, crop, crop).astype(np.float32)
    seg = rs.randint(0, 21, (n, crop, crop))
    step = make_seg_train_step(model, opt, group=group)

    def stats():
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    before = stats()
    loss = float(step(torch.from_numpy(img[rows]), torch.from_numpy(seg[rows]))["loss"])
    after = stats()
    moved = sum(float((after[k] - before[k]).abs().sum()) for k in after)
    return loss, after, moved


def run_rank(group, n: int) -> dict:
    """One rank's dry run: the three steps, their losses and seconds, and
    the stage-3 running statistics after the step."""
    t0 = time.time()
    loss1 = _stage1(group, n)
    t1 = time.time()
    loss2 = _stage2(group, n)
    t2 = time.time()
    loss3, stats, moved = _stage3(group, n)
    return dict(loss=(loss1, loss2, loss3), seconds=(t1 - t0, t2 - t1, time.time() - t2),
                stats=stats, moved=moved)


def dryrun_multichip(n: int, timeout: float = 1500.0, workdir: str | None = None) -> dict:
    """Run the dry run on n ranks, check it and print its lines; returns
    rank 0's result. Raises when a check fails, or when a rank waits on a
    peer for `timeout` seconds. The ranks' files live in a temporary
    directory under `workdir` (the system's by default)."""
    from wseg_tpu_torch.parallel.launch import spawn

    with tempfile.TemporaryDirectory(dir=workdir) as d:
        results = spawn("wseg_tpu_torch.cli.dryrun_multichip:run_rank", n, d, dict(n=n),
                        timeout=timeout)
    first = results[0]
    for r, res in enumerate(results):
        if not all(np.isfinite(res["loss"])):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} has a non-finite loss "
                               f"{res['loss']}")
        if res["loss"] != first["loss"]:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r}'s losses {res['loss']} are "
                               f"not rank 0's {first['loss']}")
        if not res["moved"] > 0:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r}'s stage-3 BN statistics did "
                               "not move")
        unequal = [k for k in first["stats"] if not torch.equal(res["stats"][k],
                                                                first["stats"][k])]
        if unequal:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r}'s stage-3 BN statistics "
                               f"differ from rank 0's at {unequal[:3]}")
    (l1, l2, l3), (t1, t2, t3) = first["loss"], first["seconds"]
    print(f"dryrun stage1 contrast loss={l1:.4f} ({t1:.0f}s)", flush=True)
    print(f"dryrun stage2 affinity loss={l2:.4f} ({t2:.0f}s)", flush=True)
    print(f"dryrun stage3 seg loss={l3:.4f} ({t3:.0f}s; {len(first['stats'])} BN statistics "
          "moved, equal on every rank)", flush=True)
    print(f"dryrun_multichip({n}) OK: loss={l1:.4f} aff_loss={l2:.4f} seg_loss={l3:.4f}",
          flush=True)
    return first


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", default=8, type=int, help="ranks (the global batch)")
    dryrun_multichip(parser.parse_args(argv).n)


if __name__ == "__main__":
    main()
