"""Stage-3 DeepLab testing CLI (counterpart of wseg_tpu/cli/seg_test.py;
reference segmentation/experiment/*/test.py:40-113): 6-scale x flip TTA,
the dense CRF (the host's native one, or with `--crf_backend tpu` the
accelerator CRF on the model's device), mIoU eval.

    python -m wseg_tpu_torch.cli.seg_test --exp SEAM_deeplabv1_resnet38 \\
        --data_root VOC2012 --ckpt model/.../deeplabv1_resnet38_VOCDataset_itr20000_all.pth

Each scale's views of a chunk of images are zero-padded to one 64-bucket
and run as one float32 batch (TF32 off) with `valid_hw`, so every view's
valid stride-8 logits equal its exact-shape forward. The host crops them,
upsamples them twice with align_corners=True (to the view, then to the
image), flips back, averages the 12 views, takes the softmax and runs the
CRF (bilateral sxy 32, one iteration) on a thread pool beside the next
chunk's forward. pngs land under `results/Segmentation/<model>_<period>/`,
mIoU in `log/<exp>/logfile.txt`.

Under torchrun (`torchrun --nproc_per_node <gpus> -m
wseg_tpu_torch.cli.seg_test ...`) each rank tests and writes its own
contiguous block of the images; the confusion matrices are summed over the
ranks, so the mIoU is the whole set's, logged by rank 0.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

# Any one forward is capped at this many padded view pixels (rows x ph x
# pw); over-cap scales run as row chunks of equal shape. The JAX package's
# value (16 images at the 1.75-scale 384x512 bucket view, 672x896), kept.
MAX_TTA_PX = 32 * 672 * 896
BATCH = 16  # images per chunk
# No cuDNN autotuning (PERF.md, stage-3 testing): on an H100, 16 VOC-sized images a
# chunk take 13.6 s a chunk with cuDNN's heuristics, while autotuning the
# chunk's 6 bucket shapes in float32 had not finished after 13 minutes.
CUDNN_BENCHMARK = False


def host_upsample(logits, out_hw):
    """(h, w, C) -> (out_h, out_w, C) bilinear with align_corners=True
    (test.py:84-87): two float32 matmuls with the resize matrices."""
    from wseg_tpu_torch.ops.resize import _resize_weights_np

    h, w, c = logits.shape
    wh = _resize_weights_np(h, out_hw[0], True)
    ww = _resize_weights_np(w, out_hw[1], True)
    y = (ww @ logits.transpose(1, 0, 2).reshape(w, h * c)).reshape(out_hw[1], h, c)
    return (wh @ y.transpose(1, 0, 2).reshape(h, out_hw[1] * c)).reshape(out_hw[0], out_hw[1], c)


def fuse_views(views, hw, n_views: int, n_classes: int = 21):
    """views: [(stride-8 logits crop (h8, w8, C), view h, view w, flipped)]
    -> (H, W, C) class probabilities: each view upsampled to its own size
    (the model's upsample, deeplabv1.py:51) and then to the image's
    (test.py:84-87), flipped back, averaged, softmax."""
    import numpy as np

    h, w = hw
    acc = np.zeros((h, w, n_classes), np.float32)
    for lg8, vh, vw, flipped in views:
        lg = host_upsample(host_upsample(lg8, (vh, vw)), (h, w))
        acc += lg[:, ::-1] if flipped else lg
    mean_logits = acc / n_views
    prob = np.exp(mean_logits - mean_logits.max(axis=-1, keepdims=True))
    return prob / prob.sum(axis=-1, keepdims=True)


def pad_views(imgs, batch_size: int, n_flip: int, bucket: int):
    """One scale's views of a chunk -> (batch (rows, ph, pw, 3), valid
    (rows, 2), cap). Every view (and its flip) is zero-padded to the chunk's
    `bucket`-multiple; the row count is the batch's, rounded up to a multiple
    of `cap`, the rows that fit MAX_TTA_PX, so every forward of a (ph, pw)
    has one shape. Filler rows repeat the last view, so no (0, 0) valid
    region reaches ASPP's masked mean (seg_test.py:191-195)."""
    import numpy as np

    vhs = [im.shape[0] for im in imgs]
    vws = [im.shape[1] for im in imgs]
    ph = -(-max(vhs) // bucket) * bucket
    pw = -(-max(vws) // bucket) * bucket
    rows = len(imgs) * n_flip
    r_pad = batch_size * n_flip
    cap = max(1, MAX_TTA_PX // (ph * pw))
    if r_pad > cap:
        r_pad = -(-r_pad // cap) * cap
    batch = np.zeros((r_pad, ph, pw, 3), np.float32)
    valid = np.ones((r_pad, 2), np.int32)
    for i, im in enumerate(imgs):
        batch[n_flip * i, :vhs[i], :vws[i]] = im
        if n_flip == 2:
            batch[n_flip * i + 1, :vhs[i], :vws[i]] = im[:, ::-1]
        valid[n_flip * i:n_flip * i + n_flip] = (vhs[i], vws[i])
    batch[rows:] = batch[rows - 1]
    valid[rows:] = valid[rows - 1]
    return batch, valid, min(cap, r_pad)


def forward_views(model, batch, valid, cap: int, device):
    """Raw stride-8 logits (rows, h8, w8, C) on the host of every row of
    `batch`, `cap` rows a forward."""
    import numpy as np
    import torch

    outs = []
    with torch.inference_mode():
        for s in range(0, len(batch), cap):
            x = torch.from_numpy(batch[s:s + cap]).to(device, non_blocking=True)
            v = torch.from_numpy(valid[s:s + cap]).to(device)
            out = model(x.permute(0, 3, 1, 2), valid_hw=v, raw_logits=True)
            outs.append(out.permute(0, 2, 3, 1).float().cpu().numpy())
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", default="SEAM_deeplabv1_resnet38")
    parser.add_argument("--data_root", default="VOC2012")
    parser.add_argument("--ckpt", required=True, help=".pth state_dict or JAX .ckpt")
    parser.add_argument("--period", default="val")
    parser.add_argument("--no_crf", action="store_true")
    parser.add_argument("--crf_backend", default="native", choices=["native", "tpu"],
                        help="native = the C++ permutohedral CRF on a host thread pool; tpu "
                        "= the accelerator CRF (ops/crf.py) on --device, called from the "
                        "same pool")
    parser.add_argument("--bucket", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=0,
                        help=f"images per TTA chunk; 0 = {BATCH}")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from wseg_tpu_torch.infer.crf_post import check_backend
    from wseg_tpu_torch.parallel.mesh import joined
    from wseg_tpu_torch.utils.device import resolve_device
    from wseg_tpu_torch.utils.logging import rank_logger

    check_backend(args.crf_backend)
    device = resolve_device(args.device)
    with joined(device) as group, rank_logger(None, group):
        _test(args, device, group)


def _test(args, device, group):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from wseg_tpu_torch.ops.crf import dense_crf_tpu
    from wseg_tpu_torch.ops.densecrf import dense_crf
    from wseg_tpu_torch.parallel.mesh import broadcast_module, rank_of, shard_indices, sync
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.seg.dataset import generate_dataset
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.utils.checkpoint import load_weights
    from wseg_tpu_torch.utils.logging import Timer, writelog

    cfg = EXPERIMENTS[args.exp].replace(DATA_ROOT=args.data_root, TEST_CKPT=args.ckpt)
    if args.no_crf:
        cfg = cfg.replace(TEST_CRF=False)
    crf = functools.partial(dense_crf_tpu, device=device) if args.crf_backend == "tpu" \
        else dense_crf
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = CUDNN_BENCHMARK

    dataset = generate_dataset(cfg, period=args.period, transform="none")
    model = generate_net(cfg, device=device).eval()
    model.load_state_dict(load_weights(args.ckpt, seg=True), strict=True)
    broadcast_module(model, group)
    print(f"loaded {args.ckpt}")
    mine = shard_indices(len(dataset), group)  # this rank's images

    batch_size = max(args.batch_size or BATCH, 1)
    n_flip = 2 if cfg.TEST_FLIP else 1
    n_views = len(cfg.TEST_MULTISCALE) * n_flip
    timer = Timer("Seg test started: ")

    def load_chunk(s):
        return [dataset[i] for i in mine[s:s + batch_size]]

    def post_image(sample, views):
        prob = fuse_views(views, (sample["row"], sample["col"]), n_views, cfg.MODEL_NUM_CLASSES)
        if cfg.TEST_CRF:
            # the reference's seg parameterisation: bilateral sxy 32, 1 iteration
            prob = crf(np.ascontiguousarray(prob.transpose(2, 0, 1)),
                       dataset.load_image(sample["name"]), n_classes=cfg.MODEL_NUM_CLASSES)
            pred = np.argmax(prob, axis=0).astype(np.uint8)
        else:
            pred = np.argmax(prob, axis=-1).astype(np.uint8)
        dataset.save_result([{"name": sample["name"], "predict": pred}], cfg.MODEL_NAME)

    # host prep (decode + multiscale resizes) and post-processing (upsamples,
    # fusion, CRF, png) overlap the device's forwards; the CRF and the BLAS
    # matmuls release the GIL
    with ThreadPoolExecutor(max_workers=2) as prep_pool, \
            ThreadPoolExecutor(max_workers=4) as post_pool:
        post_futs = []
        fut = prep_pool.submit(load_chunk, 0)
        for start in range(0, len(mine), batch_size):
            chunk = fut.result()
            if start + batch_size < len(mine):
                fut = prep_pool.submit(load_chunk, start + batch_size)
            scale_outs = []
            for rate in cfg.TEST_MULTISCALE:
                imgs = [s["image_%f" % rate] for s in chunk]
                batch, valid, cap = pad_views(imgs, batch_size, n_flip, args.bucket)
                scale_outs.append((forward_views(model, batch, valid, cap, device),
                                   [im.shape[:2] for im in imgs]))
            for i, sample in enumerate(chunk):
                views = []
                for logits8, hws in scale_outs:
                    vh, vw = hws[i]
                    lg8 = logits8[n_flip * i:n_flip * i + n_flip, :-(-vh // 8), :-(-vw // 8)]
                    views += [(lg8[j], vh, vw, j == 1) for j in range(n_flip)]
                post_futs.append(post_pool.submit(post_image, sample, views))
            # back-pressure: at most ~2 chunks of post work in flight
            while len(post_futs) > 2 * batch_size:
                post_futs.pop(0).result()
            done = min(start + batch_size, len(mine))
            if done % 25 < batch_size:
                timer.update_progress(done / len(mine))
                print(f"{done}/{len(mine)}, fin: {timer.str_est_finish()}", flush=True)
        for f in post_futs:
            f.result()
    sync(group)  # every rank's pngs are written
    elapsed = time.time() - timer.start
    print(f"{len(dataset)} images in {elapsed:.1f}s = {len(dataset) / elapsed:.2f} imgs/s "
          "end-to-end", flush=True)
    if args.period == "test":
        print("Test-period predictions saved (no local ground truth to eval)")
    else:
        resultlog = dataset.do_python_eval(cfg.MODEL_NAME, group)
        if rank_of(group) == 0:
            writelog(os.path.join(cfg.LOG_DIR, "logfile.txt"), resultlog,
                     f"{args.exp} {args.period}")
    print("Test finished")


if __name__ == "__main__":
    main()
