"""Stage-1 training CLI (counterpart of wseg_tpu/cli/contrast_train.py,
flag-compatible with the reference `contrast_train.py`).

    python -m wseg_tpu_torch.cli.contrast_train --weights W.params|W.pth|W.ckpt \\
        --voc12_root VOC2012 [--device cpu]

One dual-view step a batch (train/contrast.py) on the GPU unless `--device
cpu`; a thread-pool input pipeline with epoch-indexed shuffle and per-sample
augmentation seeds, so `--resume <train state> --start_epoch k` continues
the run that a kill after epoch k - 1 interrupted, step for step.
`--weights` is laid over the seeded init (a trunk-only file, such as the
ImageNet `.params`, leaves the heads at init). Writes
`result/<session_name>/contrast_train.pth` (the resumable state, with
`--save_every_epoch`), `result/<session_name>/contrast.pth` (weights with
the reference's key names) at the end, and the run's stdout to
`result/<session_name>/contrast.log`; `--profile_dir` traces steps 10-14.

Data parallel under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.contrast_train ...`; NCCL, or gloo with `--device cpu`):
`--batch_size` is the global batch, each rank trains on its rows of it and
the run is the one-process run at that batch (parallel/mesh.py). Rank 0
alone writes the log and the checkpoints; every rank reads `--resume`.
"""

from __future__ import annotations

import argparse
import contextlib
import os

WEIGHTS = "contrast.pth"  # result/<session_name>/<WEIGHTS>: the run's final weights


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--max_epoches", default=8, type=int)
    parser.add_argument("--network", default="contrast", type=str)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--wt_dec", default=5e-4, type=float)
    parser.add_argument("--train_list", default="voc12/train_aug.txt", type=str)
    parser.add_argument("--val_list", default="voc12/val.txt", type=str)
    parser.add_argument("--session_name", default="resnet38", type=str)
    parser.add_argument("--crop_size", default=448, type=int)
    parser.add_argument("--low_res", default=128, type=int,
                        help="second-view size (the reference downsamples the 448 crop "
                        "to 128, contrast_train.py:130-134)")
    parser.add_argument("--min_long", default=448, type=int,
                        help="RandomResizeLong range (contrast_train.py:66)")
    parser.add_argument("--max_long", default=768, type=int)
    parser.add_argument("--weights", default="", type=str,
                        help="ImageNet .params, reference .pth state_dict or JAX .ckpt; "
                        "entries that are missing or of another shape keep their init")
    parser.add_argument("--voc12_root", default="VOC2012", type=str)
    parser.add_argument("--tblog_dir", default="./tblog", type=str)
    parser.add_argument("--bg_threshold", default=0.20, type=float)
    parser.add_argument("--momentum", default=5e-4, type=float,
                        help="SGD momentum; the reference-equivalent default "
                        "(see train/optim.py)")
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--profile_dir", default="", type=str,
                        help="write a torch.profiler Chrome trace of steps 10-14 here")
    parser.add_argument("--save_every_epoch", action="store_true",
                        help="save the resumable train state after every epoch "
                        "(the reference saves only at the end)")
    parser.add_argument("--stop_after_epoch", default=0, type=int,
                        help="exit after this many epochs WITHOUT the final weights "
                        "(emulates a kill; pair with --save_every_epoch). The poly-lr "
                        "schedule still spans --max_epoches")
    parser.add_argument("--start_epoch", default=0, type=int,
                        help="first epoch of a --resume'd run: epoch-indexed shuffle and "
                        "augmentation make the continuation equal the uninterrupted run")
    parser.add_argument("--resume", default="", type=str,
                        help="resume model, optimizer and generator from a train state .pth")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                        help="bfloat16 = mixed-precision step (float32 master weights)")
    parser.add_argument("--grad_clip", default=0.0, type=float,
                        help="clip gradients to this global norm before the optimizer "
                        "(0 = off, the reference behavior; needed when training from "
                        "RANDOM init)")
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
            rank_logger(os.path.join("result", args.session_name, "contrast.log"), world):
        _train(args, device, world)


def _train(args, device, world):
    import random

    import numpy as np
    import torch

    from wseg_tpu_torch.data.loader import DataLoader
    from wseg_tpu_torch.data.voc12 import ContrastTrainDataset
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.train.contrast import make_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups
    from wseg_tpu_torch.utils.checkpoint import (
        load_train_state, load_weights, merge_state_dict, save_train_state, save_weights,
    )
    from wseg_tpu_torch.parallel.mesh import (
        broadcast_module, group_for_batch, rank_of, shard_of, sync,
    )
    from wseg_tpu_torch.utils.logging import AverageMeter, ScalarWriter, Timer
    from wseg_tpu_torch.utils.profiling import trace

    random.seed(args.seed)  # host-side augmentation without det_seed
    np.random.seed(args.seed)
    print(vars(args))

    group, trains = group_for_batch(args.batch_size, world)
    if not trains:
        return
    lead = rank_of(group) == 0  # writes the checkpoints, the scalar log and the trace
    model = build_model(args.network, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        model.load_state_dict(merge_state_dict(model.state_dict(), load_weights(args.weights),
                                               what=f"pretrained weights from {args.weights}"),
                              strict=True)
        print(f"loaded pretrained weights from {args.weights}")
    tblogger = ScalarWriter(args.tblog_dir) if lead else None

    dataset = ContrastTrainDataset(
        args.train_list, args.voc12_root, crop_size=args.crop_size,
        min_long=args.min_long, max_long=args.max_long, det_seed=args.seed)
    loader = DataLoader(dataset, args.batch_size, num_workers=args.num_workers,
                        seed=args.seed, pin_memory=device.type == "cuda",
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
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    step_fn = make_train_step(model, optimizer, args.bg_threshold, low_res=args.low_res,
                              compute_dtype=compute_dtype, grad_clip=args.grad_clip,
                              generator=generator, group=group)

    out_dir = os.path.join("result", args.session_name)
    avg_meter = AverageMeter()
    timer = Timer("Session started: ")
    pending = []  # device metric dicts, read only at the 50-step print: reading syncs

    profiler = contextlib.ExitStack()  # the trace of steps 10-14, closed by step 15 or the end
    for ep in range(args.start_epoch, args.max_epoches):
        loader.set_epoch(ep)
        for it, (_, imgs, labels) in enumerate(loader):
            if args.profile_dir and lead and global_step == 10:
                profiler.enter_context(trace(args.profile_dir))
            if global_step == 15:
                profiler.close()
            imgs = torch.as_tensor(imgs).to(device, non_blocking=True)
            labels = torch.as_tensor(labels).to(device, non_blocking=True)
            metrics = step_fn(imgs.permute(0, 3, 1, 2), labels)  # NHWC -> NCHW view
            global_step += 1

            pending.append(metrics)
            if (global_step - 1) % 50 == 0:
                for m in pending:
                    avg_meter.add({k: float(v) for k, v in m.items()})
                pending.clear()
                timer.update_progress(global_step / max_step)
                lr = args.lr * (1 - (global_step - 1) / max_step) ** 0.9
                print(
                    "Iter:%5d/%5d | " % (global_step - 1, max_step),
                    "loss: %.4f | loss_cls: %.4f | loss_er: %.4f | loss_ecr: %.4f | "
                    "loss_nce: %.4f | loss_intra_nce: %.4f | loss_cross_nce: %.4f | "
                    "loss_cross_nce2: %.4f"
                    % avg_meter.get("loss", "loss_cls", "loss_er", "loss_ecr", "loss_nce",
                                    "loss_intra_nce", "loss_cross_nce", "loss_cross_nce2"),
                    "imps:%.1f | " % ((it + 1) * args.batch_size / timer.get_stage_elapsed()),
                    "Fin:%s | " % timer.str_est_finish(),
                    "lr: %.4f" % lr,
                    flush=True,
                )
                if lead:
                    tblogger.add_scalars("loss", {k: float(v) for k, v in metrics.items()},
                                         global_step - 1)
                    tblogger.add_scalar("lr", lr, global_step - 1)
                avg_meter.pop()
        print("")
        timer.reset_stage()
        if args.save_every_epoch:
            ep_ckpt = os.path.join(out_dir, "contrast_train.pth")
            sync(group)
            if lead:
                save_train_state(ep_ckpt, model, optimizer, global_step, generator)
            print(f"epoch {ep}: saved resumable state to {ep_ckpt} "
                  f"(continue with --resume <ckpt> --start_epoch {ep + 1})", flush=True)
        if args.stop_after_epoch and ep + 1 >= args.stop_after_epoch:
            print(f"stop_after_epoch={args.stop_after_epoch}: exiting without final "
                  "weights (kill emulation)")
            profiler.close()
            return
    profiler.close()  # a run that ends inside the window writes its trace too

    print(args.session_name)
    out = os.path.join(out_dir, WEIGHTS)
    sync(group)
    if lead:
        save_weights(out, model)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
