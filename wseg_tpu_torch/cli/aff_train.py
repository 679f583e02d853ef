"""AffinityNet training CLI (counterpart of wseg_tpu/cli/aff_train.py,
flag-compatible with the reference `aff_train.py`).

    python -m wseg_tpu_torch.cli.aff_train --weights contrast.pth|.ckpt|.params \\
        --voc12_root VOC2012 --la_crf_dir crf/4.00 --ha_crf_dir crf/24.00

One float32 step a batch (train/affinity.py; TF32 off) on the GPU unless
`--device cpu`. `--weights` may hold a stage-1 net: entries of another
shape or missing ones keep their init (utils/checkpoint.py:
merge_state_dict). The input pipeline is epoch-indexed, so `--resume <train
state> --start_epoch k` continues the run that a kill after epoch k - 1
interrupted, step for step. Writes `result/<session_name>/aff_train.pth`
(the resumable state, with `--save_every_epoch`),
`result/<session_name>/aff.pth` (weights with the reference's key names) and
the run's stdout to `result/<session_name>/aff.log`.

Data parallel under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.aff_train ...`; NCCL, or gloo with `--device cpu`):
`--batch_size` is the global batch, each rank trains on its rows of it and
the run is the one-process run at that batch (parallel/mesh.py). Rank 0
alone writes the log and the checkpoints; every rank reads `--resume`.
"""

from __future__ import annotations

import argparse
import os

WEIGHTS = "aff.pth"  # result/<session_name>/<WEIGHTS>: the run's final weights


def collate(samples):
    """(image, (bg_pos, fg_pos, neg)) items -> (images, bg, fg, neg) stacks."""
    import numpy as np

    return (np.stack([s[0] for s in samples]),
            *(np.stack([s[1][i] for s in samples]) for i in range(3)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--max_epoches", default=8, type=int)
    parser.add_argument("--network", default="affinity", type=str)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--wt_dec", default=5e-4, type=float)
    parser.add_argument("--train_list", default="voc12/train_aug.txt", type=str)
    parser.add_argument("--val_list", default="voc12/val.txt", type=str)
    parser.add_argument("--session_name", default="resnet38", type=str)
    parser.add_argument("--crop_size", default=448, type=int)
    parser.add_argument("--weights", default="", type=str,
                        help=".pth state_dict, JAX .ckpt or ImageNet .params, e.g. a stage-1 "
                        "net's; entries "
                        "that are missing or of another shape keep their init")
    parser.add_argument("--voc12_root", default="VOC2012", type=str)
    parser.add_argument("--la_crf_dir", required=True, type=str)
    parser.add_argument("--ha_crf_dir", required=True, type=str)
    parser.add_argument("--momentum", default=5e-4, type=float,
                        help="SGD momentum; the reference-equivalent default "
                        "(see train/optim.py)")
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--save_every_epoch", action="store_true",
                        help="save the resumable train state after every epoch")
    parser.add_argument("--resume", default="", type=str,
                        help="resume model, optimizer and generator from a train state .pth")
    parser.add_argument("--start_epoch", default=0, type=int,
                        help="first epoch of a --resume'd run: epoch-indexed shuffle and "
                        "augmentation make the continuation equal the uninterrupted run")
    parser.add_argument("--stop_after_epoch", default=0, type=int,
                        help="exit after this many epochs without the final weights "
                        "(emulates a kill; pair with --save_every_epoch)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    if args.start_epoch > 0 and not args.resume:
        raise SystemExit(
            f"--start_epoch {args.start_epoch} without --resume would skip epochs and "
            "train from init weights with a misleading global_step/lr; pass --resume "
            "<train state> (or drop --start_epoch).")

    from wseg_tpu_torch.parallel.mesh import joined
    from wseg_tpu_torch.utils.device import resolve_device
    from wseg_tpu_torch.utils.logging import rank_logger

    device = resolve_device(args.device)
    with joined(device) as world, \
            rank_logger(os.path.join("result", args.session_name, "aff.log"), world):
        _train(args, device, world)


def _train(args, device, world):
    import random

    import numpy as np
    import torch

    from wseg_tpu_torch.data.loader import DataLoader
    from wseg_tpu_torch.data.voc12 import VOC12AffDataset
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.train.affinity import make_aff_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups
    from wseg_tpu_torch.utils.checkpoint import (
        load_train_state, load_weights, merge_state_dict, save_train_state, save_weights,
    )
    from wseg_tpu_torch.parallel.mesh import (
        broadcast_module, group_for_batch, rank_of, shard_of, sync,
    )
    from wseg_tpu_torch.utils.logging import AverageMeter, Timer

    random.seed(args.seed)  # host-side augmentation without det_seed
    np.random.seed(args.seed)
    print(vars(args))

    group, trains = group_for_batch(args.batch_size, world)
    if not trains:
        return
    lead = rank_of(group) == 0  # writes the checkpoints
    model = build_model(args.network, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        model.load_state_dict(merge_state_dict(model.state_dict(), load_weights(args.weights),
                                               what=f"entries from {args.weights}"), strict=True)
        print(f"loaded weights from {args.weights}")

    dataset = VOC12AffDataset(args.train_list, args.la_crf_dir, args.ha_crf_dir,
                              args.voc12_root, cropsize=args.crop_size, det_seed=args.seed)
    loader = DataLoader(dataset, args.batch_size, num_workers=args.num_workers, seed=args.seed,
                        pin_memory=device.type == "cuda", collate=collate,
                        shard=shard_of(group))
    steps_per_epoch = len(dataset) // args.batch_size
    max_step = steps_per_epoch * args.max_epoches

    optimizer = PolySGD(param_groups(model), args.lr, args.wt_dec, max_step,
                        momentum=args.momentum)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    global_step = args.start_epoch * steps_per_epoch
    if args.resume:
        saved_step = load_train_state(args.resume, model, optimizer, generator)
        if saved_step != global_step:
            raise SystemExit(
                f"--resume {args.resume} holds the state after step {saved_step}, but "
                f"--start_epoch {args.start_epoch} starts at step {global_step}; pass the "
                "start epoch that the file's save message named.")
        print(f"resumed full train state from {args.resume}")
    broadcast_module(model, group)
    step_fn = make_aff_train_step(model, optimizer, generator=generator, group=group)
    if device.type == "cuda":
        # one autotune for the one crop shape: in a fresh process cuDNN's
        # heuristic picked a direct conv kernel that made the f32 step at crop
        # 448, batch 8 5.3x slower on an H100 (2758 vs 525 ms, PERF.md)
        torch.backends.cudnn.benchmark = True

    out_dir = os.path.join("result", args.session_name)
    avg_meter = AverageMeter()
    timer = Timer("Session started: ")
    pending = []  # device metric dicts, read only at the 50-step print: reading syncs

    for ep in range(args.start_epoch, args.max_epoches):
        loader.set_epoch(ep)
        for it, batch in enumerate(loader):
            imgs, bg, fg, neg = (torch.as_tensor(b).to(device, non_blocking=True) for b in batch)
            pending.append(step_fn(imgs.permute(0, 3, 1, 2), bg, fg, neg))  # NHWC -> NCHW view
            global_step += 1
            if (global_step - 1) % 50 == 0:
                for m in pending:
                    avg_meter.add({k: float(v) for k, v in m.items()})
                pending.clear()
                timer.update_progress(global_step / max_step)
                print(
                    "Iter:%5d/%5d" % (global_step - 1, max_step),
                    "loss:%.4f %.4f %.4f %.4f"
                    % avg_meter.get("loss", "bg_loss", "fg_loss", "neg_loss"),
                    "cnt:%.0f %.0f %.0f" % avg_meter.get("bg_cnt", "fg_cnt", "neg_cnt"),
                    "imps:%.1f" % ((it + 1) * args.batch_size / timer.get_stage_elapsed()),
                    "Fin:%s" % timer.str_est_finish(),
                    "lr: %.4f" % (args.lr * (1 - (global_step - 1) / max_step) ** 0.9),
                    flush=True,
                )
                avg_meter.pop()
        print("")
        timer.reset_stage()
        if args.save_every_epoch:
            ep_ckpt = os.path.join(out_dir, "aff_train.pth")
            sync(group)
            if lead:
                save_train_state(ep_ckpt, model, optimizer, global_step, generator)
            print(f"epoch {ep}: saved resumable state to {ep_ckpt} "
                  f"(continue with --resume <ckpt> --start_epoch {ep + 1})", flush=True)
        if args.stop_after_epoch and ep + 1 >= args.stop_after_epoch:
            print(f"stop_after_epoch={args.stop_after_epoch}: exiting without final "
                  "weights (kill emulation)")
            return

    out = os.path.join(out_dir, WEIGHTS)
    sync(group)
    if lead:
        save_weights(out, model)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
