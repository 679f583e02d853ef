"""MSF + flip CAM inference CLI (counterpart of wseg_tpu/cli/contrast_infer.py,
flag-compatible with the reference `contrast_infer.py`).

Writes per image: `--out_cam` {cls: cam}.npy dicts, `--out_cam_pred`
argmax pngs with a constant bg score and `--out_crf` CRF'd argmax pngs
(beside the CAM work: the host's native CRF on `--num_workers` threads, or
with `--crf_backend tpu` the accelerator CRF on `--device` from one thread).
Runs on the GPU unless `--device cpu`.

    python -m wseg_tpu_torch.cli.contrast_infer --weights W.pth|W.ckpt \\
        --infer_list voc12/train.txt --voc12_root VOC2012 --out_cam out_cam

`--profile_dir` writes a torch.profiler Chrome trace of the 2nd-4th batch
(images, at batch size 0 or 1) and prints the traced counters.

Under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.contrast_infer ...`) each rank infers and writes its own
contiguous block of the list, every image on exactly one rank.
"""

from __future__ import annotations

import argparse
import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True, type=str,
                        help="reference .pth state_dict or JAX .ckpt")
    parser.add_argument("--network", default="contrast", type=str)
    parser.add_argument("--infer_list", default="voc12/train.txt", type=str)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--voc12_root", default="VOC2012", type=str)
    parser.add_argument("--out_cam", default=None, type=str)
    parser.add_argument("--out_crf", default=None, type=str)
    parser.add_argument("--out_cam_pred", default=None, type=str)
    parser.add_argument("--out_cam_pred_alpha", default=0.26, type=float)
    parser.add_argument("--crf_iters", default=10, type=int)
    parser.add_argument("--crf_backend", default="native", choices=["native", "tpu"],
                        help="native = the C++ permutohedral CRF on host threads; tpu = the "
                        "accelerator CRF (ops/crf.py) on --device")
    parser.add_argument("--bucket", default=64, type=int,
                        help="pad H/W to multiples (masked forward); 0 = exact shapes")
    parser.add_argument("--device_msf", action="store_true",
                        help="uint8 image in, view scaling and fusion on the device")
    parser.add_argument("--batch_size", default=0, type=int,
                        help="images per bucketed batch (0 or 1 = one image at a time)")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--profile_dir", default="", type=str,
                        help="write a torch.profiler Chrome trace of batches 2-4 here")
    args = parser.parse_args(argv)

    from wseg_tpu_torch.infer.crf_post import check_backend
    from wseg_tpu_torch.parallel.mesh import joined, sync
    from wseg_tpu_torch.utils.device import resolve_device
    from wseg_tpu_torch.utils.logging import rank_logger

    check_backend(args.crf_backend)
    device = resolve_device(args.device)
    with joined(device) as group, rank_logger(None, group):
        _infer(args, device, group)
        sync(group)  # every rank's files are written
        print("done")


def _infer(args, device, group):
    import os

    import numpy as np

    from wseg_tpu_torch.data.voc12 import VOC12ClsDatasetMSF, get_img_path
    from wseg_tpu_torch.infer.cam import CamInferencer, save_cam_dict, save_cam_pred
    from wseg_tpu_torch.infer.crf_post import crf_from_cam_dict
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.parallel.mesh import rank_of, shard_indices
    from wseg_tpu_torch.utils.checkpoint import load_weights
    from wseg_tpu_torch.utils.logging import Timer
    from wseg_tpu_torch.utils.profiling import trace

    model = build_model(args.network, device=device)
    if args.crf_backend == "tpu":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False  # the CRF's matmuls stay f32
    model.load_state_dict(load_weights(args.weights), strict=True)

    dataset = VOC12ClsDatasetMSF(args.infer_list, args.voc12_root)
    inferencer = CamInferencer(model, bucket=args.bucket or None, group=group)
    mine = shard_indices(len(dataset), group)  # this rank's images
    batch_size = 1 if args.device_msf else max(args.batch_size, 1)
    timer = Timer("Infer started: ")

    def prepare(pos):
        idx = mine[pos]
        if args.device_msf:
            name = dataset.img_name_list[idx]
            return name, np.array(dataset.load_image(idx)), dataset.label_list[idx], None
        return dataset[idx]

    crf_futures = []

    def write_outputs(name, norm_cam, label):
        if args.out_cam is not None:
            cam_dict = save_cam_dict(args.out_cam, name, norm_cam, label)
        else:
            cam_dict = {i: norm_cam[i] for i in range(20) if label[i] > 1e-5}
        if args.out_cam_pred is not None:
            save_cam_pred(args.out_cam_pred, name, norm_cam, args.out_cam_pred_alpha)
        if args.out_crf is not None:
            crf_futures.append(crf_pool.submit(
                crf_from_cam_dict, cam_dict, get_img_path(name, args.voc12_root),
                os.path.join(args.out_crf, name + ".png"), t=args.crf_iters,
                backend=args.crf_backend, device=device))

    # host-side decode and view scaling run ahead of the device work in a
    # bounded window of threads (PIL releases the GIL); the native CRF runs on
    # its own pool (it releases the GIL too); the tpu CRF's calls serialise on
    # the device, so one thread overlaps its host side (padding, the png)
    crf_workers = 1 if args.crf_backend == "tpu" else max(args.num_workers, 1)
    profiler = contextlib.ExitStack()  # the trace of batches 1-3, closed by batch 4 or the end
    with ThreadPoolExecutor(max_workers=4) as pool, \
            ThreadPoolExecutor(max_workers=crf_workers) as crf_pool, profiler:
        window = max(4, batch_size)
        pending = deque(pool.submit(prepare, i) for i in range(min(window, len(mine))))
        done = n_batches = 0
        while done < len(mine):
            if args.profile_dir and rank_of(group) == 0 and n_batches == 1:
                profiler.enter_context(trace(args.profile_dir))
            if n_batches == 4:
                profiler.close()
            n_batches += 1
            chunk = []
            for _ in range(min(batch_size, len(mine) - done)):
                chunk.append(pending.popleft().result())
                nxt = done + len(chunk) + len(pending)
                if nxt < len(mine):
                    pending.append(pool.submit(prepare, nxt))
            if args.device_msf:
                name, img, label, _ = chunk[0]
                cams = [inferencer.infer_one_device(img, np.asarray(label))]
            elif batch_size > 1:
                cams = inferencer.infer_batch(
                    [(views, np.asarray(label), hw) for (_, views, label, hw) in chunk])
            else:
                _, views, label, hw = chunk[0]
                cams = [inferencer.infer_one(views, np.asarray(label), hw)]
            for (name, _, label, _), norm_cam in zip(chunk, cams):
                write_outputs(name, norm_cam, label)
            done += len(chunk)
            if done % 50 < len(chunk):
                timer.update_progress(done / len(mine))
                print(f"{done}/{len(mine)} imgs, fin: {timer.str_est_finish()}", flush=True)
        for f in crf_futures:
            f.result()


if __name__ == "__main__":
    main()
