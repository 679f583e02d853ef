"""Segmentation / seed evaluation: per-class IoU over png or npy predictions
(numpy; a copy of wseg_tpu/eval/miou.py, with PIL imported where used).

Rebuild of `eval.py:13-86`. The reference fans out 8 processes that serialize
on per-class `multiprocessing.Value` int32 counters (overflow-prone,
eval.py:17-20); here each image contributes a 21x21 confusion matrix via one
`np.bincount`, accumulated in int64 across a thread pool — same numbers,
no locks, no overflow.

npy mode re-assembles the {class_idx: cam} dict into a 21-channel tensor with
the bg channel at `threshold` and argmaxes (eval.py:28-36).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wseg_tpu_torch.data.voc12 import CATEGORIES_WITH_BG


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


def _confusion_for_image(
    name: str, predict_folder: str, gt_folder: str, input_type: str,
    threshold: float | None, num_cls: int,
) -> np.ndarray:
    if input_type == "png":
        predict = _read_png(os.path.join(predict_folder, f"{name}.png"))
    elif input_type == "npy":
        d = np.load(
            os.path.join(predict_folder, f"{name}.npy"), allow_pickle=True
        ).item()
        h, w = next(iter(d.values())).shape
        tensor = np.zeros((num_cls, h, w), np.float32)
        for key, cam in d.items():
            tensor[key + 1] = cam
        tensor[0] = threshold
        predict = np.argmax(tensor, axis=0).astype(np.uint8)
    else:
        raise ValueError(input_type)

    gt = _read_png(os.path.join(gt_folder, f"{name}.png"))
    valid = gt < 255
    conf = np.bincount(
        (gt[valid].astype(np.int64) * num_cls + predict[valid].astype(np.int64)),
        minlength=num_cls * num_cls,
    ).reshape(num_cls, num_cls)
    return conf


def confusion_matrix(
    predict_folder: str, gt_folder: str, name_list, num_cls: int = 21,
    input_type: str = "png", threshold: float | None = 1.0, num_workers: int = 8,
) -> np.ndarray:
    total = np.zeros((num_cls, num_cls), np.int64)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for conf in pool.map(
            lambda n: _confusion_for_image(
                n, predict_folder, gt_folder, input_type, threshold, num_cls
            ),
            name_list,
        ):
            total += conf
    return total


def iou_from_confusion(conf: np.ndarray) -> np.ndarray:
    tp = np.diag(conf).astype(np.float64)
    t = conf.sum(axis=1).astype(np.float64)  # gt totals
    p = conf.sum(axis=0).astype(np.float64)  # pred totals
    return tp / (t + p - tp + 1e-10)


def do_python_eval(
    predict_folder: str, gt_folder: str, name_list, num_cls: int = 21,
    input_type: str = "png", threshold: float | None = 1.0,
    printlog: bool = False, num_workers: int = 8, group=None,
) -> dict:
    """Per-class IoU and mIoU of `name_list`. With a process `group`,
    `name_list` is this rank's share and the confusion matrices are summed
    over the ranks first, so every rank returns the whole list's result."""
    conf = confusion_matrix(
        predict_folder, gt_folder, name_list, num_cls, input_type, threshold, num_workers
    )
    if group is not None:
        from wseg_tpu_torch.parallel.mesh import all_reduce_array

        conf = all_reduce_array(conf, group)
    iou = iou_from_confusion(conf)
    loglist = {CATEGORIES_WITH_BG[i]: iou[i] * 100 for i in range(num_cls)}
    miou = float(np.mean(iou))
    loglist["mIoU"] = miou * 100
    if printlog:
        for i in range(num_cls):
            end = "\t" if i % 2 != 1 else "\n"
            print("%11s:%7.3f%%" % (CATEGORIES_WITH_BG[i], iou[i] * 100), end=end)
        print("\n======================================================")
        print("%11s:%7.3f%%" % ("mIoU", miou * 100))
    return loglist


def _curve_confusions_for_image(
    name: str, predict_folder: str, gt_folder: str, thresholds, num_cls: int
) -> np.ndarray:
    """Confusion matrices for every bg threshold in ONE pass over the image
    (the reference re-reads and re-argmaxes each image 60 times,
    eval.py:129-136)."""
    d = np.load(os.path.join(predict_folder, f"{name}.npy"), allow_pickle=True).item()
    h, w = next(iter(d.values())).shape
    fg = np.zeros((num_cls - 1, h, w), np.float32)
    for key, cam in d.items():
        fg[key] = cam
    fg_max = fg.max(axis=0)
    fg_arg = fg.argmax(axis=0).astype(np.int64) + 1

    gt = _read_png(os.path.join(gt_folder, f"{name}.png"))
    valid = gt < 255
    gt_v = gt[valid].astype(np.int64)
    fg_max_v = fg_max[valid]
    fg_arg_v = fg_arg[valid]

    out = np.zeros((len(thresholds), num_cls, num_cls), np.int64)
    for ti, t in enumerate(thresholds):
        pred = np.where(fg_max_v > t, fg_arg_v, 0)
        out[ti] = np.bincount(
            gt_v * num_cls + pred, minlength=num_cls * num_cls
        ).reshape(num_cls, num_cls)
    return out


def evaluate_dir(
    predict_dir: str, gt_dir: str, name_list, input_type: str = "png",
    threshold: float | None = None, curve: bool = False, num_workers: int = 8,
):
    """Single eval or the bg-threshold curve sweep (eval.py:129-136). The
    sweep loads each prediction once and evaluates all 60 thresholds."""
    if not curve:
        return do_python_eval(
            predict_dir, gt_dir, name_list, 21, input_type, threshold,
            printlog=True, num_workers=num_workers,
        )
    thresholds = [i / 100.0 for i in range(60)]
    total = np.zeros((len(thresholds), 21, 21), np.int64)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for conf in pool.map(
            lambda n: _curve_confusions_for_image(n, predict_dir, gt_dir, thresholds, 21),
            name_list,
        ):
            total += conf
    mious = []
    for ti, t in enumerate(thresholds):
        miou = float(np.mean(iou_from_confusion(total[ti]))) * 100
        mious.append(miou)
        print("%d/60 background score: %.3f\tmIoU: %.3f%%" % (ti, t, miou))
    return {"mIoU": mious}
