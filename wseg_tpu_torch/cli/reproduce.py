"""The whole three-stage chain as one command (counterpart of
wseg_tpu/cli/reproduce.py; the reference's documented usage, README.md:49-147),
with the reference's defaults everywhere:

    python -m wseg_tpu_torch.cli.reproduce --voc12_root /data/VOC2012 \\
        --weights weights/ilsvrc-cls_rna-a1_cls1000_ep-0001.params \\
        --work result/reproduce [--crf_backend tpu] [--device cpu]

runs, in order (the stage boundaries are the reference's file contracts):

  1. contrast_train   (8 epochs, batch 8, lr 0.01)
  2. contrast_infer   on the training list -> cam .npy dicts + argmax pngs
  3. eval --type npy --curve      -> the seed mIoU table
  4. aff_prepare                  -> one crf dir per alpha (4/8/16/24/32)
  5. aff_train        (la 4.00, ha 24.00)
  6. aff_infer        on the eval list -> random-walk pngs
  7. eval --type png              -> the walk mIoU table
  8. aff_infer        on the training list -> pseudo masks for DeepLab
  9. seg_train        (SEAM_deeplabv1_resnet38, 20k iterations)
 10. seg_test         (12-view TTA + dense CRF) -> the final mIoU table

Each stage is the port's own CLI (`python -m wseg_tpu_torch.cli.<stage>`) in
a fresh process, so each starts with the card's memory free. `--device` goes
to every stage that runs a net or the tpu CRF; `--crf_backend` to aff_prepare
and seg_test. Every file lands under `--work`; the stages read the file
names the CLIs write (contrast_train.WEIGHTS, aff_train.WEIGHTS,
seg_train.weights_path). The smoke knobs (--epochs, --seg_iterations,
--train_list, ...) shrink the chain; left alone they are the reference's
schedule.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(tag: str, module: str, flags: list, cwd: str) -> None:
    cmd = [sys.executable, "-m", f"wseg_tpu_torch.cli.{module}"] + [str(f) for f in flags]
    print(f"\n=== [{tag}] {' '.join(cmd)}", flush=True)
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, cwd=cwd, env=env)
    if r.returncode != 0:
        raise SystemExit(f"[{tag}] failed with rc={r.returncode}")
    print(f"=== [{tag}] done in {time.time() - t0:.0f}s", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--voc12_root", required=True,
                   help="VOC2012 root (JPEGImages/, Annotations/, SegmentationClass/, and "
                   "for stage 3 ImageSets/Segmentation/{trainaug,val}.txt)")
    p.add_argument("--weights", required=True,
                   help="ImageNet-pretrained ResNet-38 (.params or .pth), the start of "
                   "stages 1, 2 and 3")
    p.add_argument("--work", default="result/reproduce",
                   help="directory for every intermediate and final file")
    p.add_argument("--stages", default="1,2,3",
                   help="comma list of pipeline stages to run (resume support)")
    p.add_argument("--device", default="cuda",
                   help="every stage's device (the native CRF runs on the host)")
    # smoke knobs; the defaults are the reference schedule
    p.add_argument("--epochs", type=int, default=8,
                   help="contrast_train and aff_train epochs (reference: 8)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--low_res", type=int, default=None,
                   help="second-view size (reference: 128)")
    p.add_argument("--min_long", type=int, default=448)
    p.add_argument("--max_long", type=int, default=768)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="only needed when training from RANDOM init")
    p.add_argument("--train_list", default=None,
                   help="training list (reference: voc12/train_aug.txt)")
    p.add_argument("--eval_list", default=None,
                   help="seed / walk eval list (reference: voc12/train.txt)")
    p.add_argument("--alphas", default="4,8,16,24,32", help="aff_prepare's background alphas")
    p.add_argument("--la_alpha", type=float, default=4.0)
    p.add_argument("--ha_alpha", type=float, default=24.0)
    p.add_argument("--crf_backend", default="native", choices=["native", "tpu"])
    p.add_argument("--seg_exp", default="SEAM_deeplabv1_resnet38")
    p.add_argument("--seg_iterations", type=int, default=None,
                   help="override TRAIN_ITERATION (reference: 20000)")
    p.add_argument("--seg_batch_size", type=int, default=None)
    p.add_argument("--seg_crop", type=int, default=None)
    p.add_argument("--seg_bn_mom", type=float, default=None)
    p.add_argument("--seg_period", default="val",
                   help="seg_test split (the reference tests val)")
    args = p.parse_args(argv)

    stages = {s.strip() for s in args.stages.split(",") if s.strip()}
    unknown = stages - {"1", "2", "3"}
    if unknown or not stages:
        raise SystemExit(
            f"--stages got {args.stages!r}: expected a comma list drawn from 1,2,3 (e.g. "
            "--stages 2,3); " + (f"unknown tokens {sorted(unknown)}" if unknown else "empty"))

    from wseg_tpu_torch.cli import aff_train, contrast_train, seg_train
    from wseg_tpu_torch.seg.config import EXPERIMENTS

    root = os.path.abspath(args.voc12_root)
    weights = os.path.abspath(args.weights)
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    train_list = os.path.abspath(args.train_list
                                 or os.path.join(_REPO, "voc12", "train_aug.txt"))
    eval_list = os.path.abspath(args.eval_list or os.path.join(_REPO, "voc12", "train.txt"))
    device = ["--device", args.device]

    cam_dir = os.path.join(work, "cam")
    cam_pred_dir = os.path.join(work, "cam_pred")
    crf_dir = os.path.join(work, "crf")
    rw_dir = os.path.join(work, "rw")
    pseudo_dir = os.path.join(work, "pseudo")
    evallog = os.path.join(work, "evallog.txt")
    contrast_weights = os.path.join(work, "result", "contrast", contrast_train.WEIGHTS)
    aff_weights = os.path.join(work, "result", "aff", aff_train.WEIGHTS)

    if "1" in stages:
        flags = [
            "--voc12_root", root, "--weights", weights,
            "--session_name", "contrast", "--train_list", train_list,
            "--batch_size", args.batch_size, "--max_epoches", args.epochs,
            "--crop_size", args.crop_size, "--min_long", args.min_long,
            "--max_long", args.max_long, "--num_workers", args.num_workers,
        ] + device
        if args.low_res is not None:
            flags += ["--low_res", args.low_res]
        if args.grad_clip:
            flags += ["--grad_clip", args.grad_clip, "--momentum", "0.9"]
        _run("1/contrast_train", "contrast_train", flags, work)
        _run("1/contrast_infer", "contrast_infer", [
            "--weights", contrast_weights, "--voc12_root", root,
            "--infer_list", train_list, "--out_cam", cam_dir,
            "--out_cam_pred", cam_pred_dir, "--num_workers", args.num_workers,
        ] + device, work)
        _run("1/eval_seed", "eval", [
            "--list", eval_list, "--predict_dir", cam_dir,
            "--gt_dir", os.path.join(root, "SegmentationClass"),
            "--type", "npy", "--curve", "True", "--comment", "seed",
            "--logfile", evallog,
        ], work)

    if "2" in stages:
        base = [
            "--voc12_root", root, "--infer_list", train_list,
            "--cam_dir", cam_dir, "--out_crf", crf_dir,
            "--crf_backend", args.crf_backend, "--num_workers", args.num_workers,
        ] + device
        if args.alphas == "4,8,16,24,32":  # the reference's sweep is one invocation
            _run("2/aff_prepare", "aff_prepare", base, work)
        else:
            for alpha in args.alphas.split(","):
                _run(f"2/aff_prepare_a{alpha}", "aff_prepare",
                     base + ["--alpha", alpha.strip()], work)
        _run("2/aff_train", "aff_train", [
            "--voc12_root", root, "--weights", weights,
            "--train_list", train_list, "--session_name", "aff",
            "--la_crf_dir", os.path.join(crf_dir, f"{args.la_alpha:.2f}"),
            "--ha_crf_dir", os.path.join(crf_dir, f"{args.ha_alpha:.2f}"),
            "--batch_size", args.batch_size, "--max_epoches", args.epochs,
            "--crop_size", args.crop_size, "--num_workers", args.num_workers,
        ] + device, work)
        _run("2/aff_infer_eval", "aff_infer", [
            "--weights", aff_weights, "--voc12_root", root,
            "--infer_list", eval_list, "--cam_dir", cam_dir,
            "--out_rw", rw_dir, "--num_workers", args.num_workers,
        ] + device, work)
        _run("2/eval_rw", "eval", [
            "--list", eval_list, "--predict_dir", rw_dir,
            "--gt_dir", os.path.join(root, "SegmentationClass"),
            "--type", "png", "--comment", "rw", "--logfile", evallog,
        ], work)
        _run("2/aff_infer_pseudo", "aff_infer", [
            "--weights", aff_weights, "--voc12_root", root,
            "--infer_list", train_list, "--cam_dir", cam_dir,
            "--out_rw", pseudo_dir, "--num_workers", args.num_workers,
        ] + device, work)

    if "3" in stages:
        cfg = EXPERIMENTS[args.seg_exp]
        flags = [
            "--exp", args.seg_exp, "--data_root", root,
            "--pseudo_gt", pseudo_dir, "--backbone_weights", weights,
        ] + device
        if args.seg_iterations is not None:
            flags += ["--iterations", args.seg_iterations]
        if args.seg_batch_size is not None:
            flags += ["--batch_size", args.seg_batch_size]
        if args.seg_crop is not None:
            flags += ["--crop", args.seg_crop]
        if args.seg_bn_mom is not None:
            flags += ["--bn_mom", args.seg_bn_mom]
        _run("3/seg_train", "seg_train", flags, work)
        max_itr = args.seg_iterations or cfg.TRAIN_ITERATION
        seg_weights = os.path.join(work, seg_train.weights_path(cfg, f"itr{max_itr}_all"))
        _run("3/seg_test", "seg_test", [
            "--exp", args.seg_exp, "--data_root", root, "--ckpt", seg_weights,
            "--period", args.seg_period, "--crf_backend", args.crf_backend,
        ] + device, work)

    print(f"\nreproduce chain complete; mIoU tables: {evallog} (seed + rw) and "
          f"{os.path.join(work, 'log', args.seg_exp)} (final)")


if __name__ == "__main__":
    main()
