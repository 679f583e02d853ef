"""Random-walk refinement CLI (counterpart of wseg_tpu/cli/aff_infer.py,
flag-compatible with the reference `aff_infer.py`).

Per image: the CAM dict with a constant background score, refined through
the learned affinity's T^(2^logt) transition matrix on the GPU (unless
`--device cpu`), written as the argmax pseudo-mask png that stage 3 trains
on. The trunk and the walk run in float32 with TF32 off, as the JAX CLI;
`--walk_dtype bfloat16` runs the squaring chain in bf16. cuDNN autotunes
once per bucket shape (`cudnn.benchmark`).

    python -m wseg_tpu_torch.cli.aff_infer --weights aff.pth|aff.ckpt \\
        --infer_list voc12/train.txt --voc12_root VOC2012 --cam_dir out_cam \\
        --out_rw out_rw

Under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.aff_infer ...`) each rank refines and writes its own
contiguous block of the list, every image on exactly one rank.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True, type=str,
                        help="AffinityNet .pth state_dict or JAX .ckpt")
    parser.add_argument("--network", default="affinity", type=str)
    parser.add_argument("--infer_list", default="voc12/val.txt", type=str)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--cam_dir", required=True, type=str)
    parser.add_argument("--voc12_root", default="VOC2012", type=str)
    parser.add_argument("--alpha", default=6, type=float)  # kept for flag parity
    parser.add_argument("--out_rw", default="out_rw", type=str)
    parser.add_argument("--beta", default=8, type=int)
    parser.add_argument("--logt", default=6, type=int)
    parser.add_argument("--bg_score", default=0.27, type=float)
    parser.add_argument("--bucket", default=64, type=int)
    parser.add_argument("--batch_size", default=0, type=int,
                        help="images per refine_batch call; 0 = 96. Names are grouped by "
                        "bucket shape from the JPEG headers and each chunk is capped at the "
                        "walk's pixel budget (MAX_WALK_PX, 96 x 384 x 512)")
    parser.add_argument("--walk_dtype", default="float32", choices=["float32", "bfloat16"],
                        help="dtype of the matrix-power chain; float32 is reference parity")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    from wseg_tpu_torch.parallel.mesh import joined, sync
    from wseg_tpu_torch.utils.device import resolve_device
    from wseg_tpu_torch.utils.logging import rank_logger

    device = resolve_device(args.device)
    with joined(device) as group, rank_logger(None, group):
        _infer(args, device, group)
        sync(group)  # every rank's files are written
        print("done")


def _infer(args, device, group):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from wseg_tpu_torch.data.transforms import Normalize
    from wseg_tpu_torch.data.voc12 import get_img_path, load_img_name_list
    from wseg_tpu_torch.infer.cam import write_png
    from wseg_tpu_torch.infer.rw import RandomWalkRefiner
    from wseg_tpu_torch.models import build_model
    from wseg_tpu_torch.parallel.mesh import shard_indices
    from wseg_tpu_torch.utils.checkpoint import load_weights
    from wseg_tpu_torch.utils.logging import Timer

    model = build_model(args.network, device=device)
    model.load_state_dict(load_weights(args.weights), strict=True)
    refiner = RandomWalkRefiner(
        model, beta=args.beta, logt=args.logt, bucket=args.bucket,
        walk_dtype=torch.bfloat16 if args.walk_dtype == "bfloat16" else None, group=group)
    if refiner.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True  # one autotune per bucket shape
    os.makedirs(args.out_rw, exist_ok=True)
    batch_size = args.batch_size or 96
    normalize = Normalize()
    name_list = load_img_name_list(args.infer_list)
    name_list = [name_list[i] for i in shard_indices(len(name_list), group)]  # this rank's
    timer = Timer("RW infer started: ")

    def load_item(name):
        with Image.open(get_img_path(name, args.voc12_root)) as im:
            img = np.array(im.convert("RGB"))
        h, w = img.shape[:2]
        cam_dict = np.load(os.path.join(args.cam_dir, name + ".npy"), allow_pickle=True).item()
        cam_full = np.zeros((h, w, 21), np.float32)
        for k, v in cam_dict.items():
            cam_full[..., k + 1] = v
        cam_full[..., 0] = args.bg_score
        return normalize(img), cam_full

    # Group names by bucket shape from the JPEG headers (no decode), so that
    # every dispatch is a full batch of one shape, capped by the pixel budget.
    shape_groups: dict[tuple[int, int], list[str]] = {}
    for name in name_list:
        with Image.open(get_img_path(name, args.voc12_root)) as im:
            w, h = im.size
        shape_groups.setdefault(refiner.padded_size(h, w), []).append(name)
    chunks = []
    for (ph, pw), names in shape_groups.items():
        bs = min(max(batch_size, 1), refiner.chunk_size(ph, pw))
        chunks += [names[s:s + bs] for s in range(0, len(names), bs)]

    # the next chunk's decode and cam loads overlap this chunk's device work
    with ThreadPoolExecutor(max_workers=max(min(args.num_workers, 4), 1)) as pool:
        def load_chunk(chunk):
            return [load_item(n) for n in chunk]

        fut = pool.submit(load_chunk, chunks[0]) if chunks else None
        done = 0
        for ci, chunk in enumerate(chunks):
            items = fut.result()
            if ci + 1 < len(chunks):
                fut = pool.submit(load_chunk, chunks[ci + 1])
            for name, pred in zip(chunk, refiner.refine_batch(items)):
                write_png(os.path.join(args.out_rw, name + ".png"), pred)
            prev, done = done, done + len(chunk)
            if done // 50 > prev // 50 or done == len(name_list):
                timer.update_progress(done / len(name_list))
                print(f"{done}/{len(name_list)}, fin: {timer.str_est_finish()}", flush=True)


if __name__ == "__main__":
    main()
