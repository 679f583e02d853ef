"""Seed / pseudo-mask evaluation CLI (counterpart of wseg_tpu/cli/eval.py,
flag-compatible with the reference `eval.py`)."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    """`--curve False` must be false: the reference's `type=bool` makes any
    non-empty string truthy (reference eval.py:119) — accept the obvious
    spellings instead of replicating the footgun."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--list", default="./VOC2012/ImageSets/Segmentation/train.txt", type=str)
    parser.add_argument("--predict_dir", default="./out_rw", type=str)
    parser.add_argument("--gt_dir", default="./VOC2012/SegmentationClass", type=str)
    parser.add_argument("--logfile", default="./evallog.txt", type=str)
    parser.add_argument("--comment", required=True, type=str)
    parser.add_argument("--type", default="png", choices=["npy", "png"], type=str)
    parser.add_argument("--t", default=None, type=float)
    parser.add_argument("--curve", default=False, type=str2bool)
    args = parser.parse_args(argv)

    from wseg_tpu_torch.eval.miou import evaluate_dir
    from wseg_tpu_torch.utils.logging import writelog

    if args.type == "npy":
        assert args.t is not None or args.curve

    from wseg_tpu_torch.data.voc12 import load_img_name_list

    name_list = load_img_name_list(args.list)
    loglist = evaluate_dir(
        args.predict_dir, args.gt_dir, name_list,
        input_type=args.type, threshold=args.t, curve=args.curve,
    )
    writelog(args.logfile, loglist, args.comment)


if __name__ == "__main__":
    main()
