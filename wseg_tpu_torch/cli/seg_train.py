"""Stage-3 DeepLab retraining CLI (counterpart of wseg_tpu/cli/seg_train.py;
reference segmentation/experiment/*/train.py), one entry point parameterised by
experiment name with config overrides by flag:

    python -m wseg_tpu_torch.cli.seg_train --exp SEAM_deeplabv1_resnet38 \\
        --data_root VOC2012 --pseudo_gt rw_pngs --backbone_weights contrast.pth

One float32 step a batch (train/seg.py; TF32 off) on the GPU unless
`--device cpu`. `--backbone_weights` lays a stage-1 file over the backbone
(heads dropped; entries of another shape keep their init). Writes
`model/<exp>/<model>_<backbone>_<data>_epoch<e>.pth` each epoch (removing the
previous epoch's) and `..._itr<N>_all.pth` at the end, state_dicts with the
reference's keys; with `--save_state` also `seg_train_state.pth` each epoch,
which `--resume` with `--min_epoch` continues step for step. The run's stdout
goes to `log/<exp>/train.log` as well.

Data parallel under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.seg_train ...`; NCCL, or gloo with `--device cpu`):
`--batch_size` is the global batch, each rank trains on its rows of it, BN
takes its moments over the global batch, and the run is the one-process
run at that batch (parallel/mesh.py). Rank 0 alone writes the logs and the
checkpoints; every rank reads `--resume`.
"""

from __future__ import annotations

import argparse
import os


def collate(samples):
    """Sample dicts -> (images (N, H, W, 3) f32, labels (N, H, W) int32)."""
    import numpy as np

    return (np.stack([s["image"] for s in samples]),
            np.stack([s["segmentation"] for s in samples]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", default="SEAM_deeplabv1_resnet38",
                        help="experiment preset name")
    parser.add_argument("--data_root", default="VOC2012")
    parser.add_argument("--pseudo_gt", default="", help="DATA_PSEUDO_GT dir")
    parser.add_argument("--train_ckpt", default="",
                        help="seg-net weights to start from (.pth or JAX .ckpt)")
    parser.add_argument("--backbone_weights", default="",
                        help="stage-1 backbone checkpoint (.ckpt or .pth)")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--crop", type=int, default=None)
    parser.add_argument("--bn_mom", type=float, default=None,
                        help="override TRAIN_BN_MOM, the head's BN momentum (the ResNet-38 "
                        "trunk keeps its 3e-4, backbone/resnet38d.py:8); short runs need "
                        "~0.1 for the running stats to reach the batch statistics")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--save_state", action="store_true",
                        help="also save the full train state (model, optimizer, step, "
                        "generator) each epoch, for an exact resume")
    parser.add_argument("--resume", default="",
                        help="resume the full train state from a seg_train_state.pth "
                        "(--train_ckpt restores weights only, the reference's TRAIN_CKPT)")
    parser.add_argument("--min_epoch", type=int, default=None,
                        help="override TRAIN_MINEPOCH (the first epoch of a --resume'd run)")
    parser.add_argument("--stop_after_epoch", type=int, default=0,
                        help="exit after this many epochs without the final save "
                        "(kill emulation; pair with --save_state)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from wseg_tpu_torch.parallel.mesh import joined
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.utils.device import resolve_device
    from wseg_tpu_torch.utils.logging import rank_logger

    cfg = EXPERIMENTS[args.exp].replace(DATA_ROOT=args.data_root)
    if args.pseudo_gt:
        cfg = cfg.replace(DATA_PSEUDO_GT=args.pseudo_gt)
    if args.iterations:
        cfg = cfg.replace(TRAIN_ITERATION=args.iterations)
    if args.batch_size:
        cfg = cfg.replace(TRAIN_BATCHES=args.batch_size)
    if args.lr:
        cfg = cfg.replace(TRAIN_LR=args.lr)
    if args.crop:
        cfg = cfg.replace(DATA_RANDOMCROP=args.crop)
    if args.bn_mom is not None:  # 0.0 (fully frozen stats) is a valid value
        cfg = cfg.replace(TRAIN_BN_MOM=args.bn_mom)
    if args.train_ckpt:
        cfg = cfg.replace(TRAIN_CKPT=args.train_ckpt)
    if args.backbone_weights:
        cfg = cfg.replace(MODEL_BACKBONE_WEIGHTS=args.backbone_weights)
    if args.min_epoch is not None:
        cfg = cfg.replace(TRAIN_MINEPOCH=args.min_epoch)
    if cfg.TRAIN_MINEPOCH > 0 and not (args.resume or cfg.TRAIN_CKPT):
        raise SystemExit(
            f"--min_epoch {cfg.TRAIN_MINEPOCH} without --resume (or --train_ckpt) would "
            "skip epochs and train from init weights with a misleading iteration/lr; pass "
            "--resume <state> (or drop --min_epoch).")

    device = resolve_device(args.device)
    os.makedirs(cfg.MODEL_SAVE_DIR, exist_ok=True)
    with joined(device) as world, rank_logger(os.path.join(cfg.LOG_DIR, "train.log"), world):
        _train(args, cfg, device, world)


def weights_path(cfg, tag: str) -> str:
    """model/<exp>/<model>_<backbone>_<data>_<tag>.pth; a run's final
    weights are tagged `itr<N>_all`."""
    return os.path.join(cfg.MODEL_SAVE_DIR,
                        f"{cfg.MODEL_NAME}_{cfg.MODEL_BACKBONE}_{cfg.DATA_NAME}_{tag}.pth")


def _train(args, cfg, device, world):
    import random

    import numpy as np
    import torch

    from wseg_tpu_torch.data.loader import DataLoader
    from wseg_tpu_torch.parallel.mesh import (
        broadcast_module, group_for_batch, rank_of, shard_of, sync,
    )
    from wseg_tpu_torch.seg.dataset import generate_dataset
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step
    from wseg_tpu_torch.utils.checkpoint import (
        backbone_weights, load_train_state, load_weights, merge_state_dict, save_train_state,
        save_weights,
    )
    from wseg_tpu_torch.utils.logging import ScalarWriter, Timer

    random.seed(args.seed)
    np.random.seed(args.seed)
    print(cfg)

    group, trains = group_for_batch(cfg.TRAIN_BATCHES, world)
    if not trains:
        return
    lead = rank_of(group) == 0  # writes the checkpoints and the scalar log
    dataset = generate_dataset(cfg, period="train", transform="weak", det_seed=args.seed)
    loader = DataLoader(dataset, cfg.TRAIN_BATCHES, num_workers=cfg.DATA_WORKERS,
                        seed=args.seed, pin_memory=device.type == "cuda", collate=collate,
                        shuffle=cfg.TRAIN_SHUFFLE,
                        shard=shard_of(group))

    model = generate_net(cfg, device=device, generator=torch.Generator().manual_seed(args.seed))
    if cfg.MODEL_BACKBONE_WEIGHTS:
        model.load_state_dict(merge_state_dict(
            model.state_dict(), backbone_weights(cfg.MODEL_BACKBONE_WEIGHTS),
            what=f"entries from {cfg.MODEL_BACKBONE_WEIGHTS}"), strict=True)
        print(f"loaded backbone weights from {cfg.MODEL_BACKBONE_WEIGHTS}")
    if cfg.TRAIN_CKPT:
        model.load_state_dict(load_weights(cfg.TRAIN_CKPT, seg=True), strict=True)
        print(f"resumed from {cfg.TRAIN_CKPT}")

    max_itr = cfg.TRAIN_ITERATION
    optimizer = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                        cfg.TRAIN_WEIGHT_DECAY, max_itr + 1, power=cfg.TRAIN_POWER,
                        momentum=cfg.TRAIN_MOMENTUM)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    itr = cfg.TRAIN_MINEPOCH * (len(dataset) // cfg.TRAIN_BATCHES)
    if args.resume:
        saved = load_train_state(args.resume, model, optimizer, generator)
        if saved != itr:
            raise SystemExit(
                f"--resume {args.resume} holds the state after iteration {saved}, but "
                f"--min_epoch {cfg.TRAIN_MINEPOCH} starts at iteration {itr}; pass the "
                "min epoch that the file's save message named.")
        print(f"resumed full train state from {args.resume}")
    broadcast_module(model, group)
    step_fn = make_seg_train_step(model, optimizer, generator=generator,
                                  with_pred=cfg.TRAIN_TBLOG, group=group)
    if device.type == "cuda":
        # one autotune for the one crop shape, as aff_train: cuDNN's heuristic
        # made stage 2's f32 step 5.3x slower on an H100 (PERF.md)
        torch.backends.cudnn.benchmark = True

    tblogger = ScalarWriter(cfg.LOG_DIR) if lead else None
    timer = Timer("Seg train started: ")
    max_epoch = max_itr * cfg.TRAIN_BATCHES // len(dataset) + 1
    done = False
    for epoch in range(cfg.TRAIN_MINEPOCH, max_epoch):
        if done:
            break
        loader.set_epoch(epoch)
        for imgs, segs in loader:
            img = torch.as_tensor(imgs).to(device, non_blocking=True).permute(0, 3, 1, 2)
            seg = torch.as_tensor(segs).to(device, non_blocking=True)
            metrics = step_fn(img, seg)  # NHWC -> NCHW view: channels_last memory
            if itr % 100 == 0:
                now_lr = cfg.TRAIN_LR * (1 - itr / (max_itr + 1)) ** cfg.TRAIN_POWER
                loss = float(metrics["loss"])
                timer.update_progress(max(itr, 1) / max_itr)
                print(f"itr:{itr}/{max_itr} loss:{loss:.4f} lr:{now_lr:.6f} "
                      f"fin:{timer.str_est_finish()}", flush=True)
                if lead:
                    tblogger.add_scalar("loss", loss, itr)
                    tblogger.add_scalar("lr", now_lr, itr)
                if lead and cfg.TRAIN_TBLOG:
                    # input / label / pred colormaps of the last sample (train.py:107-120)
                    from wseg_tpu_torch.utils.visualization import img_denorm, voc_label2colormap

                    tblogger.add_image("Input", img_denorm(np.asarray(imgs[-1])).astype(np.uint8),
                                       itr)
                    tblogger.add_image("Label", voc_label2colormap(np.asarray(segs[-1])), itr)
                    tblogger.add_image("SEG1", voc_label2colormap(
                        metrics["pred"].cpu().numpy()), itr)
            itr += 1
            if itr >= max_itr:
                done = True
                break
        ckpt = weights_path(cfg, f"epoch{epoch}")
        sync(group)
        if lead:
            save_weights(ckpt, model)
            if os.path.exists(weights_path(cfg, f"epoch{epoch - 1}")):
                os.remove(weights_path(cfg, f"epoch{epoch - 1}"))
        print(f"{ckpt} has been saved")
        if args.save_state:
            st = os.path.join(cfg.MODEL_SAVE_DIR, "seg_train_state.pth")
            if lead:
                save_train_state(st, model, optimizer, itr, generator)
            print(f"epoch {epoch}: saved resumable state to {st} "
                  f"(continue with --resume <state> --min_epoch {epoch + 1})", flush=True)
        if args.stop_after_epoch and epoch + 1 >= args.stop_after_epoch:
            print(f"stop_after_epoch={args.stop_after_epoch}: exiting without final "
                  "checkpoint (kill emulation)")
            return

    final = weights_path(cfg, f"itr{max_itr}_all")
    sync(group)
    if lead:
        save_weights(final, model)
    print(f"{final} has been saved")


if __name__ == "__main__":
    main()
