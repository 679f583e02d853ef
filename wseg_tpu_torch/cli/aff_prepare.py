"""Low/high-alpha CRF pseudo-labels for AffinityNet training (counterpart of
wseg_tpu/cli/aff_prepare.py, flag-compatible with the reference
`aff_prepare.py`): the host's native CRF on `--num_workers` threads, or with
`--crf_backend tpu` the accelerator CRF (ops/crf.py) on `--device` (the GPU
unless `--device cpu`) from up to 4 threads.

    python -m wseg_tpu_torch.cli.aff_prepare --infer_list voc12/train_aug.txt \\
        --voc12_root VOC2012 --cam_dir out_cam --out_crf crf

Each alpha writes `<out_crf>/<alpha as %.2f>/<name>.npy`, the (21, H, W)
CRF scores (the reference ran every alpha of its list with `--alpha`,
aff_prepare.py:76-81; here each alpha has its own directory). Work is
image-major: one image's whole sweep shares its lattice builds (native) or
its colour features in one batched call (tpu).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--infer_list", default="voc12/train_aug.txt", type=str)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--voc12_root", default="VOC2012", type=str)
    parser.add_argument("--cam_dir", required=True, type=str)
    parser.add_argument("--out_crf", required=True, type=str)
    parser.add_argument("--crf_iters", default=10, type=int)
    parser.add_argument("--alpha", default=None, type=float,
                        help="single alpha; default runs the [4, 8, 16, 24, 32] sweep")
    parser.add_argument("--crf_backend", default="native", choices=["native", "tpu"],
                        help="native = the C++ permutohedral CRF on host threads; tpu = the "
                        "accelerator CRF (ops/crf.py) on --device")
    parser.add_argument("--device", default="cuda", type=str,
                        help="the tpu CRF's device (the native CRF runs on the host)")
    args = parser.parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from wseg_tpu_torch.data.voc12 import get_img_path, load_img_name_list
    from wseg_tpu_torch.infer.crf_post import check_backend, crf_with_alpha_sweep

    check_backend(args.crf_backend)
    if args.crf_backend == "tpu":
        import torch

        from wseg_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise before any work
        torch.backends.cuda.matmul.allow_tf32 = False  # the CRF's matmuls stay f32
        # a few threads pipeline the host side (decode, padding, the saves)
        # while the device runs another image; its calls serialise on the
        # device either way, and few threads bound the scores in flight
        workers = max(min(4, args.num_workers), 1)
    else:
        # the native CRF releases the GIL, so threads run images in parallel
        workers = max(args.num_workers, 1)
    name_list = load_img_name_list(args.infer_list)
    alpha_list = [args.alpha] if args.alpha is not None else [4, 8, 16, 24, 32]
    folders = {}
    for alpha in alpha_list:
        folders[alpha] = os.path.join(args.out_crf, "%.2f" % alpha)
        os.makedirs(folders[alpha], exist_ok=True)

    def work(name):
        cam_dict = np.load(os.path.join(args.cam_dir, name + ".npy"), allow_pickle=True).item()
        crfs = crf_with_alpha_sweep(cam_dict, get_img_path(name, args.voc12_root), alpha_list,
                                    t=args.crf_iters, backend=args.crf_backend,
                                    device=args.device)
        for alpha, crf in zip(alpha_list, crfs):
            np.save(os.path.join(folders[alpha], name + ".npy"), crf)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(work, name_list))
    for alpha in alpha_list:
        print(f"Info: Alpha {alpha} done!", flush=True)


if __name__ == "__main__":
    main()
