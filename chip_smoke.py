"""GPU smoke run of the PyTorch/CUDA port (wseg_tpu_torch) on one H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card of compute capability 9.0; prints nvidia-smi's name
     and power limit;
  2. build: every CUDA kernel of the port, from kernels/csrc, nvcc in parallel;
  3. PCM kernels vs plain: each PCM variant against its plain PyTorch twin
     on the card: the f32 FMA kernel (TF32 off) at the scale-2 pair of a
     384x512 image, a hw tail (700) and a masked case; the tensor-core
     kernel (bf16 features) against the bf16 rounding rule at a masked hw
     tail with C = 23 and at the main path's own shape, where it is timed
     beside the FMA kernel on the same inputs;
  4. slice parity: the full-width ContrastNet through make_fused_msf_fn at
     64x96 on the card (kernel, f32, TF32 off) against the same weights on the
     CPU (plain PCM);
  5. CAM inference at working size: make_fused_msf_fn at 384x512, 4 scales x
     flip, batch 8, bf16 trunk and f32 fusion, under torch.inference_mode();
     then CamInferencer.infer_batch on two images of different sizes (the
     bucketed, masked path). The tensor-core PCM variant's launch count and
     torch.profiler both have to show that kernel on this path;
  6. conv kernels vs plain: the dilated 3x3 conv (K2) against its plain
     version, f32 (TF32 off) at the JAX tests' shapes, a co-tiling case and a
     tail case; bf16 through the wgmma kernel at a tail case and at the
     probe's and b7's shapes, timed at both beside the mma.sync variant, the
     plain version, the bound and the F.conv2d yardstick;
  7. the conv probe (cli/conv_probe.py) at its defaults: the wgmma variant's
     launch count and torch.profiler both have to show that kernel there;
  8. training parity: one full-width dual-view step (crop 64, low_res 32,
     batch 2, f32, TF32 off, dropout off, the same intra-view keys) on the
     card and on the CPU from the same weights;
  9. training at working size: crop 448, low_res 128, batch 8, in f32 and in
     bf16: ms/step, images/s, peak memory, and one profiled step;
 10. the training CLI on a synthetic VOC root: one epoch with a per-epoch
     train state, then a --resume'd second epoch;
 11. stage-2 parity: the full-width AffinityNet on the card (f32, TF32 off)
     against the same weights on the CPU: pair affinities and refined walk
     scores (refine_batch's path, 2 images in a 128x128 bucket, logt 6),
     argmax masks equal except at near-ties; one make_aff_train_step step
     (crop 64, batch 2, dropout off);
 12. random-walk inference at working size: RandomWalkRefiner.refine_batch
     on 24 images at 384x512 (a quarter of the CLI's default 96-image chunk,
     for time) in f32: images/s, peak memory, a per-stage breakdown (trunk,
     pair affinities, dense matrix, walk) and a profiled batch; then the
     bf16 chain's time and its argmax agreement with f32;
 13. AffinityNet training at working size: crop 448, batch 8, f32 (TF32
     off): ms/step, images/s, peak memory, a profiled step;
 14. the stage-2 CLI chain on a synthetic VOC root from random weights:
     contrast_infer --out_cam --out_crf, aff_prepare (5 alphas, host seconds
     per image) with the native CRF and with --crf_backend tpu (their argmax
     labels' agreement printed), aff_train (1 epoch, then a --resume'd
     epoch, from a contrast state_dict), aff_infer; every output is checked.
 15. stage-3 parity: one train-mode step (96x128, dropout off) of DeepLab v1
     / ResNet-38 (batch 2) and v2 / ResNet-101 (batch 4) at full width on the card
     (f32, TF32 off) against the same weights on the CPU: loss, parameters
     and running-stat updates; then each net's bucketed eval forward (two
     sizes in one 64-bucket) against the exact-shape forwards;
 16. DeepLab training at the presets' size (crop 448; v1 / ResNet-38 batch
     10, v2 / ResNet-101 batch 12), f32, on cuDNN's heuristics (seg_train
     autotunes, but its ~4 + 2 min of autotuning would not fit this
     script's time limit): ms/step, images/s, peak memory, device busy and
     a profiled step;
 17. seg_test's 6-scale x flip TTA at working size: 16 VOC-sized images in
     one 64-bucketed chunk through the CLI's own functions: a device pass
     with the CLI's cudnn.benchmark, a profiled pass, the host's upsamples,
     softmax and native CRF per image, alone and on the CLI's 4 threads;
     then the CLI end to end on the same images;
 18. the stage-3 CLI chain on a synthetic seg root from random weights:
     seg_train (a contrast state_dict as the backbone, 1 epoch with a train
     state, then a resumed epoch), seg_test (chunks of 4) with the native
     CRF, with --crf_backend tpu and with --no_crf; every png, the eval log
     and the rate line are checked;
 19. the accelerator CRF (ops/crf.py, --crf_backend tpu): (a) on the card
     against the CPU at 128x160 x 21 labels (both methods; the CLIs' three
     calls: aff_prepare's 5-alpha sweep, contrast_infer's label CRF,
     seg_test's dense CRF; a smooth image and one with flat regions),
     max |dQ| and argmax agreement gated, agreement with the native CRF
     printed; (b) the three calls on phase 17's 16 VOC-sized images: ms an
     image on the card's timeline and of the wall, peak memory, a profiled
     image, beside the native CRF's host seconds an image;
 20. the bench twin (cli/bench.py) in this process: --mode cam at its
     defaults (384x512, batch 8, bf16) with --iters and --baseline_reps cut
     for time (value, vs_baseline, the ceiling; the tensor-core PCM kernel
     on the fused path by count and by torch.profiler), then --mode train in
     f32 at crop 448, batch 8; the PCM kernel held against its plain twin on
     the inputs the cam run gave it, one of each shape and dtype (both
     variants: the fused path's and the f32 baseline's);
 21. SEAMNet: the full-width net on the card (PCM kernel, f32, TF32 off)
     against the CPU (plain PCM) at 64x96; a bf16 forward at crop 448,
     batch 8: ms, peak memory, PCM launches, and the tensor-core kernel
     held against its plain twin on the inputs that forward gave it;
 22. the stage-3 nets no preset uses: one train step card vs CPU of DeepLab
     v1-caffe / ResNet-38 (batch 2), v3 / ResNet-101 and v3+ / Xception
     (batch 4), gated as phase 15; v3+ / Xception training at crop 448,
     batch 10, f32 on cuDNN's heuristics (ms, images/s, peak memory, a
     profiled step); a bucketed eval forward of v3 (against exact) and v3+
     (card against CPU).
 23. data parallelism (wseg_tpu_torch/parallel/) on the card: a NCCL group
     of world size 1 over a file store (the machine has one card; more
     ranks are checked by the gloo CPU tests). One step of each trainer
     (stage 1 at crop 64, stage 2 at crop 64, stage 3 v1 / ResNet-38 at
     96x128, batch 2, dropout on) with the group against the same step
     without one: losses, parameters and stage 3's running-stat updates
     gated; CamInferencer with the group on 8 images at 384x512 in f32 (the
     CLI's dtype): its cams equal the ones without a group, and K1 is held
     against its plain twin on the inputs this path gave it;
     parallel/spatial.py:pcm_spatial against ops/pcm.py.
Stages 2 and 3 run no kernel of the port (stage 2's pair affinities, dense
matrix and walk are plain PyTorch, as they are plain XLA in the JAX package;
stage 3's convs are cuDNN's, as the JAX nets' are XLA's; the accelerator CRF
is torch ops, as it is XLA ops there); phases 16, 17, 19 and 22 check
that neither K1 nor K2 launched. K1's row counts its launches on phases 5,
20, 21 and 23, by path in `launches_by_path`.
The second-to-last lines are the kernel table as JSON and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.
Weights are random, from a seed; nothing is downloaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from wseg_tpu_torch.infer.cam import CamInferencer, make_fused_msf_fn
from wseg_tpu_torch.kernels import _build, conv_cuda, pcm_cuda
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import Dropout
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain
from wseg_tpu_torch.ops.pairs import pairwise_affinity_sliced
from wseg_tpu_torch.ops.pcm import pcm_flat, pcm_flat_bf16
from wseg_tpu_torch.train.contrast import make_train_step
from wseg_tpu_torch.train.optim import PolySGD, param_groups

SEED = 0
RTOL, ATOL = 2e-3, 2e-4          # the kernel's tolerance (tests/test_pcm_pallas.py)
SLICE_ATOL = 1e-3                # fused CAM, card (kernel) vs CPU (plain)
SEAM_CAM_RTOL = 1e-4             # SEAMNet's raw fc8 CAM, card vs CPU, of its max
H0, W0, BATCH = 384, 512, 8      # bench.py --mode cam working size
SCALES = (0.5, 1.0, 1.5, 2.0)
PCM_KERNEL_NAME = "pcm_mma_kernel"         # bf16 features, the main path
PCM_KERNEL_NAMES = ("pcm_mma_kernel", "pcm_prep_kernel")  # PCM's device time
CONV_KERNEL_NAME = "conv3x3_wgmma_kernel"  # bf16, TMA-able shapes, the probe path
CONV_RTOL = 1e-4                 # K2 in f32 (TF32 off), tests/test_conv_pallas.py
CONV_BF16_RTOL = 1e-2            # K2 in bf16: bf16 output, a relative step of 2^-8;
CONV_BF16_ATOL_RMS = 1e-2        # atol is this times the RMS of the f32 plain result
TRAIN_RTOL = 1e-3                # training step, card vs CPU
# gradient targets of tests/test_gradient_parity.py, and frozen parameters
TRAIN_TARGETS = ["fc8.weight", "fc_proj.weight", "f9.weight", "f8_3.weight", "f8_4.weight",
                 "b7.conv_branch2a.weight", "b3.conv_branch2a.weight",
                 "b4_2.conv_branch2b1.weight"]
FROZEN = ["conv1a.weight", "b2.conv_branch2a.weight", "b5.bn_branch2a.weight"]
BUILD_SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"

# NVIDIA H100 data sheet, dense: f32 on the CUDA cores (FLOP/s), HBM (B/s)
PEAKS = {"PCIe": (51e12, 2.0e12), "SXM": (67e12, 3.35e12)}
BF16_PEAKS = {"PCIe": 756e12, "SXM": 989e12}  # tensor cores, dense


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[str, float, float]:
    part = "PCIe" if "PCIe" in name else "SXM"
    return (part, *PEAKS[part])


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    return torch.cuda.get_device_name(0), card


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")


def pcm_inputs(gen, n, hw, cf, c=21, f_dtype=torch.float32, masked=False):
    dev = "cuda"
    f = torch.randn(n, hw, cf, generator=gen, device=dev).to(f_dtype)
    cam = torch.rand(n, hw, c, generator=gen, device=dev)
    mask = (torch.rand(n, hw, generator=gen, device=dev) > 0.3).float() if masked else None
    return cam, f, mask


def pcm_flops(n, hw, cf, c=21) -> float:
    return 2.0 * n * hw * hw * (cf + c)


def pcm_bytes(cam, f, mask) -> float:
    """Each input read once, the output (cam's shape and dtype) written once."""
    b = 2 * cam.numel() * cam.element_size() + f.numel() * f.element_size()
    return b + (mask.numel() * mask.element_size() if mask is not None else 0)


def phase_kernel_vs_plain(card_name: str) -> dict:
    """Each variant against its plain twin on the same inputs: f32 features
    (the FMA kernel) against pcm_flat, bf16 features (the tensor-core
    kernel) against pcm_flat_bf16, the rounding rule that kernel shares with
    the TPU kernel (fn rounded once to bf16, products in f32)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hw2 = (H0 // 8 * 2) * (W0 // 8 * 2)  # stride-8 map of the scale-2 view
    cases = [
        ("scale2_pair_f32", dict(n=2, hw=hw2, cf=192)),
        ("tail_hw700", dict(n=1, hw=700, cf=64)),
        ("tail_hw700_cf192", dict(n=2, hw=700, cf=192)),
        ("masked_scale1", dict(n=4, hw=hw2 // 4, cf=192, masked=True)),
        ("tail_hw700_bf16_masked_c23", dict(n=2, hw=700, cf=192, c=23, masked=True,
                                            f_dtype=torch.bfloat16)),
        ("main_path_bf16", dict(n=2 * BATCH, hw=hw2, cf=192, f_dtype=torch.bfloat16)),
    ]
    part, f32_peak, peak_bw = peaks(card_name)
    row = None
    for name, kw in cases:
        cam, f, mask = pcm_inputs(gen, **kw)
        variant = pcm_cuda.pcm_variant(f.dtype, kw["cf"])
        plain = pcm_flat_bf16 if f.dtype == torch.bfloat16 else pcm_flat
        before = pcm_cuda.variant_launches[variant]
        got = pcm_cuda.pcm_fused(cam, f, mask=mask)
        torch.cuda.synchronize()
        want = plain(cam, f, mask=mask)
        err = (got - want).abs()
        tol = ATOL + RTOL * want.abs()
        ok = bool((err <= tol).all()) and pcm_cuda.variant_launches[variant] == before + 1
        msg = (f"[kernel] {name} {tuple(f.shape)} {str(f.dtype)[6:]} variant {variant} "
               f"max_abs_err={err.max().item():.3e} max_rel_err={(err / want.abs().clamp_min(1e-12)).max().item():.3e} "
               f"within rtol={RTOL} atol={ATOL}: {ok}")
        if name in ("scale2_pair_f32", "main_path_bf16"):
            ms = cuda_ms(lambda: pcm_cuda.pcm_fused(cam, f, mask=mask))
            plain_ms = cuda_ms(lambda: plain(cam, f, mask=mask), iters=3, warmup=1)
            flops, nbytes = pcm_flops(kw["n"], kw["hw"], kw["cf"]), pcm_bytes(cam, f, mask)
            peak = BF16_PEAKS[part] if variant == "mma" else f32_peak
            t_ops, t_bytes = flops / peak * 1e3, nbytes / peak_bw * 1e3
            msg += (f" | {card_name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {max(t_ops, t_bytes):.3f} ms ({flops / 1e9:.1f} GFLOP at the "
                    f"{'bf16 tensor-core' if variant == 'mma' else 'f32 CUDA-core'} peak, "
                    f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.1f} TFLOP/s")
            if name == "main_path_bf16":
                fma_ms = cuda_ms(lambda: pcm_cuda.pcm_fused(cam, f, mask=mask, variant="fma"))
                msg += (f"; the FMA kernel on the same bf16 inputs {fma_ms:.3f} ms "
                        f"({flops / fma_ms / 1e9:.1f} TFLOP/s)")
                row = {
                    "name": "pcm_fused", "route": "cuda",
                    "source": "wseg_tpu_torch/kernels/csrc/pcm.cu",
                    "replaces": "wseg_tpu/kernels/pcm_pallas.py:56",
                    "launches": None, "max_abs_err": float(err.max().item()),
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": None,
                }
        print(msg, flush=True)
        del want, err, tol
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"chip_smoke: PCM kernel disagrees with its plain version ({name})")
    return row


def phase_slice_parity():
    """Full width on the card (kernel) vs the CPU (plain PCM), same weights."""
    h0, w0, b = 64, 96, 2
    gen = torch.Generator().manual_seed(SEED + 1)
    model_cpu = build_model("contrast", device="cpu",
                            generator=torch.Generator().manual_seed(SEED)).eval()
    model_gpu = build_model("contrast", generator=torch.Generator().manual_seed(SEED)).eval()
    views = tuple(torch.randn(b, 2, 3, round(h0 * s), round(w0 * s), generator=gen)
                  for s in SCALES)
    label = (torch.rand(b, 20, generator=gen) > 0.5).float()
    want = make_fused_msf_fn(model_cpu, (h0, w0))(views, label)
    pcm_cuda.reset_launches()
    got = make_fused_msf_fn(model_gpu, (h0, w0))(tuple(v.cuda() for v in views), label.cuda())
    torch.cuda.synchronize()
    launches = pcm_cuda.variant_launches["fma"]
    err = (got.cpu() - want).abs().max().item()
    print(f"[slice-parity] fused CAM {tuple(got.shape)} card (kernel, f32, TF32 off) vs CPU "
          f"(plain): max_abs_err={err:.3e} (atol {SLICE_ATOL}), PCM launches {launches}", flush=True)
    if launches != len(SCALES) or pcm_cuda.launches != len(SCALES):
        raise SystemExit(f"chip_smoke: expected {len(SCALES)} f32 PCM launches, saw {launches} "
                         f"of {pcm_cuda.launches}")
    if not err <= SLICE_ATOL:
        raise SystemExit("chip_smoke: the slice on the card disagrees with the CPU")


def check_fused(out: torch.Tensor, shape):
    """Shape, finite, and the fusion's range: (s - min - e) / (max - min + e)
    lies in [0, 1] wherever it is not the per-map floor (< 0) that the
    reference's normalization gives pixels below min + e. A pixel just above
    that threshold may land below 0 by the threshold's rounding in f32,
    ulp(min + e) / 2 over the same divisor: at most 2^-24 of |floor|, so
    2^-23 of it (float32's eps) is allowed there."""
    if tuple(out.shape) != shape:
        raise SystemExit(f"chip_smoke: output shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("chip_smoke: non-finite values in the fused CAM")
    floor = out.amin(dim=(-2, -1), keepdim=True)
    low = out.float() - torch.finfo(torch.float32).eps * floor.float()
    if not bool(((out <= 1.0) & ((low >= 0.0) | (out == floor))).all()):
        raise SystemExit(f"chip_smoke: fused CAM outside [0, 1] beyond the per-map floor "
                         f"and its rounding: max {float(out.max())}, least value off the "
                         f"floor {float(torch.where(out == floor, 1.0, out).min())}")


def profile_kernels(run):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            totals[e.key] = totals.get(e.key, 0.0) + us / 1e3
    return totals


def phase_working_size(card: str) -> int:
    torch.backends.cudnn.benchmark = True
    model = build_model("contrast", generator=torch.Generator().manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    views = tuple(torch.rand(BATCH, 2, 3, round(H0 * s), round(W0 * s), generator=gen,
                             device="cuda").to(torch.bfloat16) for s in SCALES)
    label = (torch.rand(BATCH, 20, generator=gen, device="cuda") > 0.5).float()
    fn = make_fused_msf_fn(model, (H0, W0))

    out = fn(views, label)  # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pcm_cuda.reset_launches()
    t0 = time.perf_counter()
    out = fn(views, label)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = pcm_cuda.variant_launches["mma"]
    check_fused(out, (BATCH, 20, H0, W0))
    if launches < 1 or launches != pcm_cuda.launches:
        raise SystemExit(f"chip_smoke: the main path launched {launches} tensor-core PCM "
                         f"kernels of {pcm_cuda.launches} PCM launches")
    peak_mem = torch.cuda.max_memory_allocated()

    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(views, label)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / iters

    totals = profile_kernels(lambda: fn(views, label))
    pcm_ms = sum(v for k, v in totals.items() if any(n in k for n in PCM_KERNEL_NAMES))
    if not any(PCM_KERNEL_NAME in k and v > 0 for k, v in totals.items()):
        raise SystemExit(f"chip_smoke: torch.profiler saw no {PCM_KERNEL_NAME} on the main path")
    busy = sum(totals.values())
    print(f"{card} | slice 384x512 4 scales x flip, batch {BATCH}, bf16 trunk, f32 fusion: "
          f"{BATCH / steady:.2f} images/s (mean of {iters} batches, {steady * 1e3:.1f} ms/batch; "
          f"first timed batch {dt * 1e3:.1f} ms)", flush=True)
    print(f"{card} | peak device memory {peak_mem / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    print(f"{card} | PCM launches per image {launches / BATCH:.3f} "
          f"({launches} per batch of {BATCH})")
    print(f"{card} | profiled batch: device busy {busy:.1f} ms; PCM kernels "
          f"({' + '.join(PCM_KERNEL_NAMES)}) {pcm_ms:.2f} ms ({100 * pcm_ms / busy:.2f}% of "
          f"device time)")
    for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{card} |   {v:9.2f} ms  {k[:110]}")

    # the bucketed, masked path: two images of different sizes in one batch
    rng = np.random.RandomState(SEED)
    items = []
    for i, (h, w) in enumerate([(333, 500), (375, 441)]):
        views_i = []
        for s in SCALES:
            v = rng.randn(round(h * s), round(w * s), 3).astype(np.float32)
            views_i += [v, v[:, ::-1].copy()]
        lab = np.zeros(20, np.float32)
        lab[[i, 14]] = 1.0
        items.append((views_i, lab, (h, w)))
    inferencer = CamInferencer(model, bucket=64)
    pcm_cuda.reset_launches()
    cams = inferencer.infer_batch(items)
    torch.cuda.synchronize()
    masked_launches = pcm_cuda.variant_launches["mma"]
    for cam, (_, _, hw) in zip(cams, items):
        check_fused(torch.from_numpy(cam), (20, *hw))
    totals_b = profile_kernels(lambda: inferencer.infer_batch(items))
    if masked_launches < 1 or not any(PCM_KERNEL_NAME in k for k in totals_b):
        raise SystemExit("chip_smoke: the bucketed (masked) path did not run the tensor-core "
                         "PCM kernel")
    print(f"{card} | infer_batch bucketed+masked, 2 images (333x500, 375x441): "
          f"PCM launches {masked_launches}", flush=True)
    return launches


def conv_inputs(gen, shape, co, dtype):
    x = torch.randn(shape, generator=gen, device="cuda")
    k = torch.randn((3, 3, shape[3], co), generator=gen, device="cuda") / (9 * shape[3]) ** 0.5
    return x.to(dtype), k.to(dtype)


def phase_conv_vs_plain(card_name: str, card: str) -> dict:
    """K2 against its plain version on the same inputs: f32 (TF32 off) at
    the JAX tests' shapes plus a tail case; bf16 (the wgmma kernel) at a
    tail case and at the probe's and b7's shapes against the plain version
    in f32 on the same bf16 inputs; and its time at both beside the
    mma.sync variant on the same inputs, its plain version, its bound and
    one F.conv2d call (the yardstick, channels_last; the port never calls
    it)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    f32_cases = [  # name, x shape, CO, dilation, tile_co
        ("jax_test_d1", (2, 16, 16, 8), 16, 1, 16),
        ("jax_test_d2", (2, 16, 16, 8), 16, 2, 16),
        ("jax_test_d4", (2, 16, 16, 8), 16, 4, 16),
        ("co_tiling_8", (1, 8, 8, 4), 32, 2, 8),
        ("co_tiling_32", (1, 8, 8, 4), 32, 2, 32),
        ("tail_h13_ci37_co150", (2, 13, 19, 37), 150, 3, 64),
    ]
    for name, shape, co, d, tco in f32_cases:
        x, k = conv_inputs(gen, shape, co, torch.float32)
        before = conv_cuda.launches
        got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tco)
        torch.cuda.synchronize()
        want = conv3x3_dilated_plain(x, k, d)
        err = (got - want).abs()
        ok = bool((err <= CONV_RTOL + CONV_RTOL * want.abs()).all()) and \
            conv_cuda.launches == before + 1
        print(f"[conv] {name} x {shape} -> {co} d={d} tile_co={tco} f32: "
              f"max_abs_err={err.max().item():.3e} within rtol=atol={CONV_RTOL}: {ok}", flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: conv kernel disagrees with its plain version ({name})")

    part, _, peak_bw = peaks(card_name)
    row = None
    for name, shape, co, d, tco in [
            ("tail_w100_ci40_bf16", (2, 13, 100, 40), 136, 5, 128),
            ("probe_bf16", (2 * BATCH, H0 // 8, W0 // 8, 1024), 2048, 4, 256),
            ("b7_bf16", (2 * BATCH, H0 // 4, W0 // 4, 1024), 2048, 4, 256)]:
        x, k = conv_inputs(gen, shape, co, torch.bfloat16)
        variant = conv_cuda.conv_variant(x.dtype, shape[3], co, x.data_ptr() % 16 == 0)
        before = conv_cuda.variant_launches["wgmma"]
        got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tco).float()
        torch.cuda.synchronize()
        want = conv3x3_dilated_plain(x.float(), k.float(), d)
        err = (got - want).abs()
        atol = CONV_BF16_ATOL_RMS * float(want.pow(2).mean().sqrt())
        ok = bool((err <= atol + CONV_BF16_RTOL * want.abs()).all()) and variant == "wgmma" \
            and conv_cuda.variant_launches["wgmma"] == before + 1
        max_err = err.max().item()
        print(f"[conv] {name} x {shape} -> {co} d={d} tile_co={tco} bf16 variant {variant} "
              f"tile {conv_cuda.conv_tile_shape(shape[1], shape[2])}: max_abs_err={max_err:.3e} "
              f"within rtol={CONV_BF16_RTOL} atol={atol:.3e}: {ok}", flush=True)
        del got, want, err
        if not ok:
            raise SystemExit(f"chip_smoke: conv kernel disagrees with its plain version ({name})")
        if name.startswith("tail"):
            continue
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory
        k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ms = cuda_ms(lambda: conv_cuda.conv3x3_dilated(x, k, dilation=d))
        mma_sync_ms = cuda_ms(lambda: conv_cuda.conv3x3_dilated(x, k, dilation=d,
                                                                variant="mma_sync"))
        plain_ms = cuda_ms(lambda: conv3x3_dilated_plain(x.float(), k.float(), d),
                           iters=2, warmup=1)
        library_ms = cuda_ms(lambda: F.conv2d(x_nchw, k_oihw, padding=d, dilation=d))
        n, h, w, ci = shape
        flops = 2.0 * 9 * n * h * w * ci * co
        nbytes = 2.0 * (x.numel() + k.numel() + n * h * w * co)
        t_ops, t_bytes = flops / BF16_PEAKS[part] * 1e3, nbytes / peak_bw * 1e3
        print(f"{card} | K2 conv3x3_dilated {name} ({n}, {h}, {w}, {ci}) -> {co} d={d}: "
              f"wgmma kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), mma.sync kernel "
              f"{mma_sync_ms:.3f} ms ({flops / mma_sync_ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, F.conv2d {library_ms:.3f} ms "
              f"({flops / library_ms / 1e9:.1f} TFLOP/s), bound {max(t_ops, t_bytes):.3f} ms "
              f"({flops / 1e12:.2f} TFLOP at the bf16 tensor-core peak; {nbytes / 1e9:.3f} GB)",
              flush=True)
        row = {  # the last case, b7's shape, stands for K2 in the kernel table
            "name": "conv3x3_dilated", "route": "cuda",
            "source": "wseg_tpu_torch/kernels/csrc/conv3x3.cu",
            "replaces": "wseg_tpu/kernels/conv_pallas.py:56",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        }
    torch.cuda.empty_cache()
    return row


def phase_conv_probe(card: str) -> int:
    """K2's path: the probe entry point at its defaults."""
    from wseg_tpu_torch.cli import conv_probe

    conv_cuda.reset_launches()
    totals = profile_kernels(lambda: conv_probe.main([]))
    launches = conv_cuda.variant_launches["wgmma"]
    k2_ms = sum(v for k, v in totals.items() if CONV_KERNEL_NAME in k)
    print(f"{card} | conv probe: K2 launches {conv_cuda.variant_launches}, torch.profiler "
          f"{CONV_KERNEL_NAME} {k2_ms:.1f} ms", flush=True)
    if launches < 1 or launches != conv_cuda.launches or k2_ms <= 0:
        raise SystemExit("chip_smoke: the conv probe did not run the wgmma K2 kernel")
    torch.cuda.empty_cache()
    return launches


def disable_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_train_parity():
    """One training step on the card and on the CPU, same weights and keys."""
    n, hi, low = 2, 64, 32
    rng = np.random.RandomState(SEED + 4)
    img = torch.from_numpy(rng.randn(n, 3, hi, hi).astype(np.float32) * 0.5)
    label = torch.zeros(n, 20)
    label[0, 2] = label[1, 6] = label[1, 11] = 1
    m = n * (low // 8) ** 2
    us = tuple(torch.from_numpy(rng.rand(m).astype(np.float32)) for _ in range(2))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model("contrast", device=dev, generator=torch.Generator().manual_seed(SEED))
        disable_dropout(model)
        named = dict(model.named_parameters())
        before = {k: named[k].detach().clone() for k in FROZEN}
        opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
        mets = make_train_step(model, opt, 0.2, low_res=low)(
            img.to(dev), label.to(dev), us=tuple(u.to(dev) for u in us))
        for k in FROZEN:
            if not torch.equal(named[k].detach(), before[k]):
                raise SystemExit(f"chip_smoke: frozen parameter {k} moved on {dev}")
        runs[dev] = ({k: float(v) for k, v in mets.items()},
                     {k: named[k].detach().cpu() for k in TRAIN_TARGETS + FROZEN},
                     {k: named[k].grad.cpu() for k in TRAIN_TARGETS})
        del model, opt
    (m_cpu, p_cpu, g_cpu), (m_gpu, p_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    loss_err = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    param_err = {k: rel_err(p_gpu[k], p_cpu[k]) for k in TRAIN_TARGETS}
    grad_err = {k: rel_err(g_gpu[k], g_cpu[k]) for k in TRAIN_TARGETS}
    print(f"[train-parity] losses card vs CPU (f32, TF32 off), max rel err "
          f"{max(loss_err.values()):.3e}: " + ", ".join(f"{k} {m_gpu[k]:.5f}" for k in m_gpu),
          flush=True)
    print(f"[train-parity] updated params max rel err {max(param_err.values()):.3e}; "
          f"gradients max rel err {max(grad_err.values()):.3e} (reported, not gated)")
    for k in FROZEN:
        if not torch.equal(p_gpu[k], p_cpu[k]):
            raise SystemExit(f"chip_smoke: frozen parameter {k} differs card vs CPU")
    if max(loss_err.values()) > TRAIN_RTOL or max(param_err.values()) > TRAIN_RTOL:
        raise SystemExit("chip_smoke: the training step on the card disagrees with the CPU")
    torch.cuda.empty_cache()


def phase_train_working_size(card: str):
    """Full-width training at the CLI's default size: crop 448, low_res 128,
    batch 8; f32 (1 warm-up + 3 timed steps), then bf16 (1 + 2), then one
    profiled step of each. Random init, so gradients are clipped (norm 5)."""
    n, crop, low = 8, 448, 128
    model = build_model("contrast", generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    img = torch.randn(n, 3, crop, crop, generator=gen, device="cuda")
    img = img.contiguous(memory_format=torch.channels_last)
    label = (torch.rand(n, 20, generator=gen, device="cuda") > 0.85).float()
    label[:, 14] = 1.0  # every image has a class
    named = dict(model.named_parameters())
    before = {k: named[k].detach().clone() for k in TRAIN_TARGETS + FROZEN}
    opt = PolySGD(param_groups(model), 0.01, 5e-4, 1000)

    for dtype, timed in ((None, 3), (torch.bfloat16, 2)):
        step = make_train_step(model, opt, 0.2, low_res=low, compute_dtype=dtype, grad_clip=5.0,
                               generator=torch.Generator(device="cuda").manual_seed(SEED))
        mets = step(img, label)  # warm-up (cuDNN autotune)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            mets = step(img, label)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / timed
        peak = torch.cuda.max_memory_allocated()
        vals = {k: float(v) for k, v in mets.items()}
        tag = "bf16" if dtype else "f32 (TF32 off)"
        print(f"{card} | train step crop {crop} low_res {low} batch {n} {tag}: "
              f"{dt * 1e3:.1f} ms/step, {n / dt:.2f} images/s (mean of {timed} steps after 1 "
              f"warm-up), peak device memory {peak / 2**30:.2f} GiB; last losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            raise SystemExit(f"chip_smoke: non-finite training loss ({tag})")
    for k in TRAIN_TARGETS:
        if torch.equal(named[k].detach(), before[k]):
            raise SystemExit(f"chip_smoke: trainable parameter {k} did not change")
    for k in FROZEN:
        if not torch.equal(named[k].detach(), before[k]):
            raise SystemExit(f"chip_smoke: frozen parameter {k} changed")

    for dtype in (None, torch.bfloat16):
        step = make_train_step(model, opt, 0.2, low_res=low, compute_dtype=dtype, grad_clip=5.0,
                               generator=torch.Generator(device="cuda").manual_seed(SEED))
        step(img, label)
        totals = profile_kernels(lambda: step(img, label))
        busy = sum(totals.values())
        print(f"{card} | profiled {'bf16' if dtype else 'f32'} train step: device busy "
              f"{busy:.1f} ms; top kernels:")
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:12]:
            print(f"{card} |   {v:9.2f} ms {100 * v / busy:5.1f}%  {k[:100]}")
    del model, opt, step
    torch.cuda.empty_cache()


def make_voc(root: Path, n: int = 4):
    """A VOC-style root of `n` random JPEGs with one-object XML labels."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    names = []
    for i, cat in enumerate(["dog", "cat", "person", "car"][:n]):
        name = f"2007_{i:06d}"
        arr = (rng.rand(300 + 20 * i, 400, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "JPEGImages" / f"{name}.jpg")
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><object><name>{cat}</name></object></annotation>")
        names.append(name)
    (root.parent / "train.txt").write_text("".join(f"{x}\n" for x in names))
    return str(root), str(root.parent / "train.txt")


def phase_train_cli(card: str):
    """The training CLI: one epoch with a train state, then a resumed epoch."""
    from wseg_tpu_torch.cli import contrast_train
    from wseg_tpu_torch.utils.checkpoint import load_weights

    torch.backends.cudnn.benchmark = False  # as a fresh process has it: the CLI sets nothing
    shutil.rmtree(BUILD_SCRATCH, ignore_errors=True)
    root, train_list = make_voc(BUILD_SCRATCH / "VOC2012")
    common = ["--train_list", train_list, "--voc12_root", root, "--crop_size", "448",
              "--batch_size", "2", "--grad_clip", "5.0", "--num_workers", "2",
              "--session_name", "smoke", "--tblog_dir", str(BUILD_SCRATCH / "tblog")]
    cwd = os.getcwd()
    os.chdir(BUILD_SCRATCH)
    try:
        t0 = time.perf_counter()
        contrast_train.main(common + ["--max_epoches", "1", "--save_every_epoch"])
        contrast_train.main(common + ["--max_epoches", "2", "--start_epoch", "1", "--resume",
                                      "result/smoke/contrast_train.pth"])
        dt = time.perf_counter() - t0
        sd = load_weights("result/smoke/contrast.pth")
    finally:
        os.chdir(cwd)
    build_model("contrast", device="cpu").load_state_dict(sd, strict=True)
    if not all(bool(torch.isfinite(v).all()) for v in sd.values()):
        raise SystemExit("chip_smoke: non-finite weights after the training CLI")
    print(f"{card} | training CLI: 1 epoch + a resumed epoch (4 images, batch 2, crop 448) "
          f"in {dt:.1f} s; contrast.pth loads with load_weights ({len(sd)} tensors)", flush=True)
    shutil.rmtree(BUILD_SCRATCH, ignore_errors=True)

def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_of_max: float) -> float:
    """The largest |got - want| / (atol + rtol |want|), atol = atol_of_max x
    max |want|: at most 1 when within the tolerance."""
    atol = atol_of_max * float(want.abs().max())
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def stage2_items(rng, n: int, sizes, n_cams: int | None = None):
    """n (normalised image (H, W, 3), cam (H, W, 21) with bg 0.27) pairs of
    the given sizes (cycled); with n_cams, only that many distinct cams."""
    items, cams = [], {}
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        key = (i % n_cams if n_cams else i, h, w)
        if key not in cams:
            cam = rng.random((h, w, 21), dtype=np.float32)
            cam[..., 0] = 0.27
            cams[key] = cam
        items.append((rng.standard_normal((h, w, 3), dtype=np.float32), cams[key]))
    return items


def aff_targets(rng, n: int, size: int):
    """(bg_pos, fg_pos, neg) of n random label maps at a size x size grid."""
    from wseg_tpu_torch.data.affinity_labels import ExtractAffinityLabelInRadius

    extract = ExtractAffinityLabelInRadius(size)
    labs = [extract(rng.choice(np.array([0, 5, 12, 255], np.uint8), size=(size, size),
                               p=[0.4, 0.25, 0.2, 0.15])) for _ in range(n)]
    return tuple(torch.from_numpy(np.stack([lab[k] for lab in labs])) for k in range(3))


def spread_affinities(model):
    """Scale f9 by 0.01: at random init the f9 features are large (mean |f|
    ~ 230), every pair affinity underflows to 0, the walk is the identity
    and the training losses have no gradient; scaled, the affinities spread
    over about (0.1, 0.5), as a trained net's do."""
    with torch.no_grad():
        model.f9.weight.mul_(0.01)
    return model


def phase_stage2_parity():
    """AffinityNet on the card vs the CPU, same weights: pair affinities,
    refined walk scores and masks; one training step."""
    from wseg_tpu_torch.infer.rw import RandomWalkRefiner
    from wseg_tpu_torch.train.affinity import make_aff_train_step

    models = {dev: spread_affinities(build_model(
        "affinity", device=dev, generator=torch.Generator().manual_seed(SEED)).eval())
              for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(SEED + 6)
    items = stage2_items(rng, 2, [(120, 128), (128, 100)])
    out = {}
    for dev, model in models.items():
        refiner = RandomWalkRefiner(model, logt=6)
        imgs, cams = refiner.pad(items)
        with torch.inference_mode():
            aff = model(imgs)
        scores = refiner.walk_scores(imgs, cams)
        bf16 = RandomWalkRefiner(model, logt=6, walk_dtype=torch.bfloat16).walk_scores(imgs, cams)
        out[dev] = (aff.cpu(), scores.cpu(), refiner.refine_batch(items), bf16.cpu())
    (aff_c, sc_c, masks_c, bf_c), (aff_g, sc_g, masks_g, bf_g) = out["cpu"], out["cuda"]
    # the bf16 chain (f32 accumulation pinned on the card) against the CPU's,
    # at the CPU tests' bound against the JAX package's bf16 chain
    bf_err = float((bf_g - bf_c).abs().max() / bf_c.abs().max())
    bf_agree = float((bf_g.argmax(1) == bf_c.argmax(1)).float().mean())
    aff_err, sc_err = within(aff_g, aff_c, 1e-4, 1e-5), within(sc_g, sc_c, 1e-4, 1e-5)
    top2 = sc_c.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1] < 1e-4).numpy()
    flips = 0
    for j, (mc, mg) in enumerate(zip(masks_c, masks_g)):
        h, w = mc.shape
        flips += int(((mc != mg) & ~near[j, :h, :w]).sum())
    print(f"[stage2-parity] AffinityNet 2 x 128x128 bucket, card (f32, TF32 off) vs CPU: pair "
          f"affinities {tuple(aff_g.shape)} error {aff_err:.3e} of the tolerance, walk scores "
          f"{tuple(sc_g.shape)} (logt 6) {sc_err:.3e} of the tolerance (rtol 1e-4, atol 1e-5 x "
          f"max); mask pixels differing outside near-ties (top-2 margin < 1e-4): {flips} "
          f"(near-ties {int(near.sum())}); the bf16 chain: max difference {bf_err:.3e} of the "
          f"scores' max (bound 2^-7; a bf16 reduction over hw = 256 would be far above it), "
          f"argmax agreement {100 * bf_agree:.3f}% (reported, not gated)", flush=True)
    if aff_err > 1 or sc_err > 1 or flips or bf_err > 2.0 ** -7:
        raise SystemExit("chip_smoke: stage-2 inference on the card disagrees with the CPU")

    n, crop = 2, 64
    img = torch.from_numpy(rng.standard_normal((n, 3, crop, crop), dtype=np.float32))
    labels = aff_targets(rng, n, crop // 8)
    targets = ["f9.weight", "f8_5.weight", "f8_3.weight", "b7.conv_branch2a.weight",
               "b3.conv_branch2a.weight"]
    runs = {}
    for dev in ("cpu", "cuda"):
        model = spread_affinities(build_model("affinity", device=dev,
                                              generator=torch.Generator().manual_seed(SEED)))
        disable_dropout(model)
        named = dict(model.named_parameters())
        opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
        mets = make_aff_train_step(model, opt)(img.to(dev), *(t.to(dev) for t in labels))
        runs[dev] = ({k: float(v) for k, v in mets.items()},
                     {k: named[k].detach().cpu() for k in targets},
                     {k: named[k].grad.cpu() for k in targets})
    (m_c, p_c, g_c), (m_g, p_g, g_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c)
    param_err = max(rel_err(p_g[k], p_c[k]) for k in targets)
    grad_err = max(rel_err(g_g[k], g_c[k]) for k in targets)
    print(f"[stage2-parity] make_aff_train_step crop {crop} batch {n}, card vs CPU: losses max "
          f"rel err {loss_err:.3e} ({', '.join(f'{k} {v:.5f}' for k, v in m_g.items())}); "
          f"params {param_err:.3e}; gradients {grad_err:.3e} (reported, not gated)", flush=True)
    if loss_err > TRAIN_RTOL or param_err > TRAIN_RTOL:
        raise SystemExit("chip_smoke: the stage-2 training step on the card disagrees with the CPU")
    torch.cuda.empty_cache()


def print_top(card: str, totals: dict, k: int = 12):
    busy = sum(totals.values())
    for name, v in sorted(totals.items(), key=lambda kv: -kv[1])[:k]:
        print(f"{card} |   {v:9.2f} ms {100 * v / busy:5.1f}%  {name[:100]}")


WALK_IMAGES = 24  # of the CLI's 96-image chunk: autotuning the batch-96 trunk took ~250 s


def phase_rw_working_size(card: str):
    """refine_batch at 384x512 on WALK_IMAGES images, one chunk of the
    CLI's (96 images: checked, but a quarter of it is run to keep this
    script inside its time limit), with cuDNN autotuned as in the aff_infer
    CLI."""
    torch.backends.cudnn.benchmark = True
    from wseg_tpu_torch.infer.rw import MAX_WALK_PX, RandomWalkRefiner
    from wseg_tpu_torch.models.affinity import clamped_radius
    from wseg_tpu_torch.ops.pairs import dense_affinity_matrix, pair_index_tensors
    from wseg_tpu_torch.ops.random_walk import random_walk_refine

    model = spread_affinities(
        build_model("affinity", generator=torch.Generator().manual_seed(SEED)).eval())
    refiner = RandomWalkRefiner(model, logt=6)
    n = refiner.chunk_size(H0, W0)
    if n != MAX_WALK_PX // (H0 * W0) or n != 96:
        raise SystemExit(f"chip_smoke: expected a chunk of 96 at {H0}x{W0}, got {n}")
    n = WALK_IMAGES
    items = stage2_items(np.random.default_rng(SEED + 7), n, [(H0, W0)], n_cams=8)

    refiner.refine_batch(items)  # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        masks = refiner.refine_batch(items)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    for (im, _), m in zip(items, masks):
        if m.dtype != np.uint8 or m.shape != im.shape[:2] or m.max() > 20:
            raise SystemExit("chip_smoke: a refined mask has the wrong type, shape or range")
    print(f"{card} | random walk refine_batch {n} x {H0}x{W0} f32 (TF32 off), logt 6: "
          + ", ".join(f"{t * 1e3:.1f} ms ({n / t:.2f} images/s)" for t in times)
          + f" (2 batches after 1 warm-up; host padding and copies included); peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)

    # where the time goes: each stage of walk_scores on the same padded batch
    imgs, cams = refiner.pad(items)
    h8, w8 = H0 // 8, W0 // 8
    radius = clamped_radius(h8, w8, model.radius)
    with torch.inference_mode():
        f = model.features(imgs)
        aff = model(imgs)
        ind = pair_index_tensors(radius, (h8, w8), imgs.device)
        mat = dense_affinity_matrix(aff, *ind, h8 * w8)
        stages = {
            "trunk + heads (features)": lambda: model.features(imgs),
            "pair affinities (sliced)": lambda: pairwise_affinity_sliced(f, radius),
            "dense matrix (scatter)": lambda: dense_affinity_matrix(aff, *ind, h8 * w8),
            "walk (power, 6 squarings, propagate, upsample)":
                lambda: random_walk_refine(cams, mat, logt=6),
            "the same walk with the bf16 chain":
                lambda: random_walk_refine(cams, mat, logt=6, compute_dtype=torch.bfloat16),
        }
        ms = {k: cuda_ms(fn, iters=1, warmup=1) for k, fn in stages.items()}
    total = sum(v for k, v in ms.items() if "bf16" not in k)
    walk_flops = n * (6 * 2.0 * (h8 * w8) ** 3)
    print(f"{card} | stages at {n} x {H0}x{W0} (CUDA events, 1 run each after 1 warm-up; "
          f"shares of the f32 path): "
          + "; ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in ms.items())
          + f"; the walk's squarings are {walk_flops / 1e12:.1f} TFLOP", flush=True)
    del f, aff, mat, imgs, cams
    torch.cuda.empty_cache()

    totals = profile_kernels(lambda: refiner.refine_batch(items))
    print(f"{card} | profiled refine_batch: device busy {sum(totals.values()):.1f} ms; top "
          f"kernels:")
    print_top(card, totals)

    bf16 = RandomWalkRefiner(model, logt=6, walk_dtype=torch.bfloat16)
    bf16.refine_batch(items)  # warm-up
    t0 = time.perf_counter()
    masks_bf16 = bf16.refine_batch(items)
    dt = time.perf_counter() - t0
    agree = np.mean([float((a == b).mean()) for a, b in zip(masks, masks_bf16)])
    print(f"{card} | the same batch with the bf16 squaring chain: {dt * 1e3:.1f} ms "
          f"({n / dt:.2f} images/s); argmax agreement with f32 {100 * agree:.3f}% of pixels",
          flush=True)
    del model, refiner, bf16
    torch.cuda.empty_cache()


def phase_aff_train_working_size(card: str):
    """AffinityNet training at the CLI's defaults: crop 448, batch 8, f32,
    cuDNN autotuned as in the aff_train CLI."""
    from wseg_tpu_torch.train.affinity import make_aff_train_step

    n, crop = 8, 448
    model = spread_affinities(build_model("affinity",
                                          generator=torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(SEED + 8)
    img = torch.from_numpy(rng.standard_normal((n, 3, crop, crop), dtype=np.float32)).cuda()
    img = img.contiguous(memory_format=torch.channels_last)
    labels = tuple(t.cuda() for t in aff_targets(rng, n, crop // 8))
    opt = PolySGD(param_groups(model), 0.01, 5e-4, 1000)
    step = make_aff_train_step(model, opt,
                               generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.backends.cudnn.benchmark = True  # as the aff_train CLI
    mets = step(img, *labels)  # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = 3
    t0 = time.perf_counter()
    for _ in range(timed):
        mets = step(img, *labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in mets.items()}
    print(f"{card} | AffinityNet train step crop {crop} batch {n} f32 (TF32 off): "
          f"{dt * 1e3:.1f} ms/step, {n / dt:.2f} images/s (mean of {timed} steps after 1 "
          f"warm-up), peak device memory {peak / 2**30:.2f} GiB; last losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
    if not all(np.isfinite(v) for v in vals.values()):
        raise SystemExit("chip_smoke: non-finite AffinityNet training loss")
    totals = profile_kernels(lambda: step(img, *labels))
    print(f"{card} | profiled AffinityNet train step: device busy {sum(totals.values()):.1f} ms; "
          f"top kernels:")
    print_top(card, totals)
    del model, opt, step
    torch.cuda.empty_cache()


def check_pngs(folder: Path, names, sizes, what: str):
    from PIL import Image

    for name, (h, w) in zip(names, sizes):
        arr = np.asarray(Image.open(folder / f"{name}.png"))
        if arr.dtype != np.uint8 or arr.shape != (h, w) or arr.max() > 20:
            raise SystemExit(f"chip_smoke: {what} png {name}: {arr.dtype} {arr.shape} "
                             f"max {arr.max()}")


def phase_stage2_cli(card: str):
    """contrast_infer --out_cam --out_crf -> aff_prepare -> aff_train (1
    epoch + a resumed one) -> aff_infer on a synthetic VOC root."""
    from PIL import Image

    from wseg_tpu_torch.cli import aff_infer, aff_prepare, aff_train, contrast_infer
    from wseg_tpu_torch.utils.checkpoint import load_weights, save_weights

    torch.backends.cudnn.benchmark = False  # contrast_infer sets nothing; aff_* set it on
    base = BUILD_SCRATCH / "stage2"
    shutil.rmtree(base, ignore_errors=True)
    root, lst = make_voc(base / "VOC2012")
    names = Path(lst).read_text().split()
    sizes = [Image.open(Path(root) / "JPEGImages" / f"{nm}.jpg").size[::-1] for nm in names]
    contrast_pth = str(base / "contrast.pth")
    save_weights(contrast_pth, build_model("contrast", device="cpu",
                                           generator=torch.Generator().manual_seed(SEED)))
    t = {}
    cwd = os.getcwd()
    os.chdir(base)
    try:
        t0 = time.perf_counter()
        contrast_infer.main(["--weights", contrast_pth, "--infer_list", lst, "--voc12_root", root,
                             "--out_cam", "cam", "--out_crf", "crf_png"])
        t["contrast_infer --out_cam --out_crf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        aff_prepare.main(["--infer_list", lst, "--voc12_root", root, "--cam_dir", "cam",
                          "--out_crf", "crf"])
        t_prep = time.perf_counter() - t0
        t["aff_prepare (5 alphas)"] = t_prep
        t0 = time.perf_counter()
        aff_prepare.main(["--infer_list", lst, "--voc12_root", root, "--cam_dir", "cam",
                          "--out_crf", "crf_tpu", "--crf_backend", "tpu"])
        t_tpu = time.perf_counter() - t0
        t["aff_prepare --crf_backend tpu (5 alphas)"] = t_tpu
        common = ["--train_list", lst, "--voc12_root", root, "--batch_size", "2",
                  "--num_workers", "2", "--la_crf_dir", "crf/4.00", "--ha_crf_dir",
                  "crf/24.00", "--weights", contrast_pth, "--session_name", "smoke"]
        t0 = time.perf_counter()
        aff_train.main(common + ["--max_epoches", "1", "--save_every_epoch"])
        aff_train.main(common + ["--max_epoches", "2", "--start_epoch", "1", "--resume",
                                 "result/smoke/aff_train.pth"])
        t["aff_train (1 epoch + a resumed epoch)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        aff_infer.main(["--weights", "result/smoke/aff.pth", "--infer_list", lst,
                        "--voc12_root", root, "--cam_dir", "cam", "--out_rw", "rw"])
        t["aff_infer"] = time.perf_counter() - t0
        sd = load_weights("result/smoke/aff.pth")
    finally:
        os.chdir(cwd)
    build_model("affinity", device="cpu").load_state_dict(sd, strict=True)
    if not all(bool(torch.isfinite(v).all()) for v in sd.values()):
        raise SystemExit("chip_smoke: non-finite AffinityNet weights after aff_train")
    check_pngs(base / "crf_png", names, sizes, "contrast_infer --out_crf")
    check_pngs(base / "rw", names, sizes, "aff_infer")
    agree = []
    for alpha in ("4.00", "8.00", "16.00", "24.00", "32.00"):
        for name, (h, w) in zip(names, sizes):
            arr = np.load(base / "crf" / alpha / f"{name}.npy")
            acc = np.load(base / "crf_tpu" / alpha / f"{name}.npy")
            for a in (arr, acc):
                if a.shape != (21, h, w) or not np.isfinite(a).all():
                    raise SystemExit(f"chip_smoke: aff_prepare {alpha}/{name}: {a.shape}")
            agree.append(float((arr.argmax(0) == acc.argmax(0)).mean()))
    px = sum(h * w for h, w in sizes)
    print(f"{card} | stage-2 CLI chain on {len(names)} synthetic images ({px / len(names):.0f} "
          f"px each): " + "; ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; aff_prepare host {t_prep / len(names):.3f} s per image (5 alphas, "
          f"{os.cpu_count()} cores, native CRF {px / len(names) / 1e6:.3f} MP), with "
          f"--crf_backend tpu {t_tpu / len(names):.3f} s per image; tpu vs native argmax "
          f"labels agree on {min(agree):.4f}-{max(agree):.4f} of the pixels (mean "
          f"{np.mean(agree):.4f})", flush=True)
    shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# stage 3: DeepLab training and 6-scale x flip testing


def seg_cfg(exp: str, **kw):
    from wseg_tpu_torch.seg.config import EXPERIMENTS

    return EXPERIMENTS[exp].replace(**kw)


def seg_net(cfg, device="cuda"):
    """A stage-3 net with random weights from SEED, its cls_conv scaled by
    0.02: a raw He-init head starts at CE ~ 13 (most pixels confidently
    wrong), scaled it starts near ln 21, as a net from stage-1 weights does."""
    from wseg_tpu_torch.seg.deeplab import generate_net

    model = generate_net(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.cls_conv.weight.mul_(0.02)
    return model


def seg_batch(gen, n: int, crop: int, device="cuda"):
    """n random normalised images and labels 0..20 with ~10% 255."""
    img = torch.randn(n, 3, crop, crop, generator=gen, device=device)
    lab = torch.randint(0, 21, (n, crop, crop), generator=gen, device=device)
    lab[torch.rand(n, crop, crop, generator=gen, device=device) < 0.1] = 255
    return img.contiguous(memory_format=torch.channels_last), lab


def seg_parity_inputs():
    """4 images of 96x128 with different global content, as photos have, and
    labels 0..20 with ~10% 255; the generator that drew them."""
    gen = torch.Generator().manual_seed(SEED + 9)
    img = torch.randn(4, 3, 96, 128, generator=gen)
    img = img * torch.tensor([1.0, 0.6, 1.3, 0.8])[:, None, None, None] \
        + torch.tensor([0.0, 0.8, -0.4, 0.3])[:, None, None, None]
    lab = torch.randint(0, 21, (4, 96, 128), generator=gen)
    lab[torch.rand(4, 96, 128, generator=gen) < 0.1] = 255
    return img, lab, gen


class SumTerms:
    """Hooks that record what one train step sums into a conv bias or a BN
    running mean. For `<conv>.bias`: the conv's output z and its gradient t
    (the bias gradient is t summed over (N, H, W)); for `<bn>.running_mean`
    of a batch-statistics BatchNorm2d: its input t (the update adds
    `momentum` times t's mean over (N, H, W)). keys=None hooks every such
    tensor of the model."""

    def __init__(self, model, keys=None):
        from wseg_tpu_torch.models.layers import BatchNorm2d

        self.z, self.t, self.grad, self.momentum, self.handles = {}, {}, {}, {}, []
        for path, mod in model.named_modules():
            if isinstance(mod, torch.nn.Conv2d) and mod.bias is not None \
                    and (keys is None or f"{path}.bias" in keys):
                self.handles.append(mod.register_forward_hook(self._output(f"{path}.bias")))
            elif isinstance(mod, BatchNorm2d) and not mod.frozen \
                    and (keys is None or f"{path}.running_mean" in keys):
                self.momentum[f"{path}.running_mean"] = mod.momentum
                self.handles.append(mod.register_forward_pre_hook(self._input(
                    f"{path}.running_mean")))

    def _output(self, k):
        def hook(mod, args, out):
            self.z[k] = out.detach().clone()
            out.register_hook(lambda g: self.t.__setitem__(k, g.detach().clone()))
        return hook

    def _input(self, k):
        def hook(mod, args):
            self.t[k] = args[0].detach().clone()
        return hook

    def remove(self, model):
        """Remove the hooks and keep the hooked conv biases' gradients."""
        for h in self.handles:
            h.remove()
        named = dict(model.named_parameters())
        self.grad = {k: named[k].grad.detach().clone() for k in self.z
                     if named[k].grad is not None}


def seg_step(cfg, img, lab, dev, hook=False):
    """One train-mode step (dropout keep-all) of cfg's net on `dev` through
    make_seg_train_step: (loss, state_dict before and after on the CPU,
    SumTerms of every conv bias and running mean if `hook`, else None)."""
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    model = seg_net(cfg, dev)
    disable_dropout(model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                  cfg.TRAIN_WEIGHT_DECAY, cfg.TRAIN_ITERATION + 1, momentum=0.9)
    hooks = SumTerms(model) if hook else None
    mets = make_seg_train_step(model, opt)(img.to(dev), lab.to(dev))
    if hooks:
        hooks.remove(model)
    return (float(mets["loss"]), before,
            {k: v.detach().cpu() for k, v in model.state_dict().items()}, hooks)


def seg_step_f64(cfg, img, lab, keys, device="cuda"):
    """The same step as seg_step's in float64 on `device`, the loss too
    (make_seg_train_step takes it in float32): the state_dict after it, on
    the CPU, and SumTerms of `keys`."""
    import torch.nn.functional as F

    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params

    model = seg_net(cfg, device).double()
    disable_dropout(model)
    labels = seg_label_params(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    opt = PolySGD(param_groups(model, labels), cfg.TRAIN_LR, cfg.TRAIN_WEIGHT_DECAY,
                  cfg.TRAIN_ITERATION + 1, momentum=0.9)
    hooks = SumTerms(model, keys)
    lab = lab.to(device)
    out = model.train()(img.to(device, torch.float64))
    loss = F.cross_entropy(out, lab, ignore_index=255, reduction="sum") / (lab != 255).sum()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    hooks.remove(model)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, hooks


def sum_referee(k, init, card, ref) -> tuple[str, bool]:
    """Gate the card's f32 value of `k`, a conv bias or BN running mean
    that f32 cannot compute to TRAIN_RTOL on these inputs, in the terms it
    sums, against the float64 step `ref` (seg_step_f64, which hooks every
    conv bias): (its report, within the gate).

    Flips: where a ReLU after a biased conv took the other side of 0 in f32
    (its gradient term is 0 on one side only), the card's pre-activation
    must be within TRAIN_RTOL of its max from float64's, with the sign
    flipped. Terms: the card's within TRAIN_RTOL of float64's max; for a
    bias, whose terms are gradients, only at the (N, H, W) positions where
    no biased conv of the same map size flipped (a flip moves a whole term
    there, and the terms of the positions it reaches through the 1x1 layers
    after it); a running mean's terms are forward values, which a flip
    moves by no more than the pre-activation's rounding. Sum: the card's gradient (a bias) or running mean
    within the recursive-summation bound of the exact sum of its own terms,
    gamma_n * sum|t| per channel, n the terms a channel, gamma_n = n u / (1
    - n u), u = 2^-24; for a mean, that times momentum / n, plus one ulp of
    the stored stat."""
    _, _, after, terms = card
    dims = (0, 2, 3)
    flips, wrong = 0, 0
    t_c, t_r = terms.t[k].double(), ref.t[k].double()
    keep = torch.ones_like(t_c[:, :1], dtype=torch.bool)  # (N, 1, H, W)
    for b, z_r in ref.z.items():
        t_b, z_b = terms.t[b].double(), terms.z[b].double()
        flip = (t_b == 0) != (ref.t[b] == 0)
        flips += int(flip.sum())
        wrong += int((flip & ((torch.sign(z_b) == torch.sign(z_r)) | (
            (z_b - z_r).abs() > TRAIN_RTOL * z_r.abs().max()))).sum())
        if k.endswith(".bias") and flip.shape[2:] == t_c.shape[2:]:
            keep &= ~flip.any(dim=1, keepdim=True)
    terms_err = float(((t_c - t_r).abs() * keep).max() / t_r.abs().max()) / TRAIN_RTOL
    n = t_c.numel() // t_c.shape[1]
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    if k.endswith(".bias"):
        got, exact, bound = terms.grad[k].double(), t_c.sum(dims), gamma * t_c.abs().sum(dims)
    else:
        m, got = terms.momentum[k], after[k].double().to(t_c.device)
        exact = (1 - m) * init[k].double().to(t_c.device) + m * t_c.mean(dims)
        ulp = torch.from_numpy(np.spacing(got.abs().float().cpu().numpy())).double()
        bound = m * gamma * t_c.abs().mean(dims) + ulp.to(t_c.device)
    sum_err = float(((got - exact).abs() / bound).nan_to_num(nan=0.0, posinf=np.inf).max())
    return (f"{flips} ReLU decisions after biased convs flipped in f32 ({wrong} not explained "
            f"by the forward); terms {terms_err:.3e} of the bound from float64's at all but "
            f"{int((~keep).sum())} positions; the sum {sum_err:.3e} of gamma_n sum|t| from the "
            f"exact sum of its own terms"), wrong == 0 and terms_err <= 1 and sum_err <= 1


def seg_step_parity(tag: str, cfg, img, lab, f64_referee: bool = False):
    """One train-mode step (dropout keep-all) of cfg's net on the card and
    on the CPU from the same weights, f32 with TF32 off: the loss and every
    parameter within TRAIN_RTOL relative, every running-stat update within
    TRAIN_RTOL of the update plus one ulp of the stat.

    With `f64_referee`, a tensor over its bound is measured against a
    float64 step on the card as well. Where the CPU's own f32 result misses
    the float64 one by more than the bound too, f32 cannot compute that
    tensor to the bound on these inputs. Two kinds were seen: DeepLab
    v1-caffe's conv_fov and conv_fov2 biases, whose one-step gradient moves
    by a whole term when a ReLU decision flips (1-2 of 1.5M pre-activations
    within rounding of 0), and the batch mean of a 1x1 conv of
    batch-normalised features (Xception's pointwise convs), zero but for
    rounding. A conv bias or BN running mean of that kind is gated in the
    terms it sums (sum_referee); any other tensor stays gated as above."""
    n = len(img)
    runs = {dev: seg_step(cfg, img, lab, dev, hook=f64_referee and dev == "cuda")
            for dev in ("cpu", "cuda")}
    (loss_c, init, sd_c, *_), (loss_g, _, sd_g, *_) = runs["cpu"], runs["cuda"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)

    def over_bound(got, want, k) -> float:
        """|got - want| in units of the bound: at most 1 when within it."""
        if not k.endswith(("running_mean", "running_var")):
            return rel_err(got[k].double(), want[k].double()) / TRAIN_RTOL
        d_got, d_want = got[k].double() - init[k], want[k].double() - init[k]
        ulp = float(np.spacing(np.float32(want[k].abs().max())))
        return float((d_got - d_want).abs().max()) / (TRAIN_RTOL * float(d_want.abs().max())
                                                      + ulp)

    errs = {k: over_bound(sd_g, sd_c, k) for k in sd_c}
    failed = [k for k, v in errs.items() if v > 1]
    if failed and f64_referee:
        sd_r, ref = seg_step_f64(cfg, img, lab, failed + list(runs["cuda"][3].z))
        for k in failed:
            e_card, e_cpu = over_bound(sd_g, sd_r, k), over_bound(sd_c, sd_r, k)
            msg = (f"[seg-parity] {tag} {k} (max |value| {float(sd_r[k].abs().max()):.3e}): "
                   f"card vs CPU {errs[k]:.3e} of the bound; against a float64 step on the "
                   f"card: card {e_card:.3e}, CPU {e_cpu:.3e} of it")
            if e_cpu > 1 and k in ref.t:
                report, ok = sum_referee(k, init, runs["cuda"], ref)
                msg += f": ill-conditioned in f32, gated in its terms: {report}"
                if ok:
                    errs.pop(k)
            print(msg + ("" if k not in errs else ": over the bound"), flush=True)
        failed = [k for k in failed if k in errs]
    del runs
    params = {k: v * TRAIN_RTOL for k, v in errs.items()
              if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v for k, v in errs.items() if k.endswith(("running_mean", "running_var"))}
    (pk, param_err), (sk, stat_err) = (max(d.items(), key=lambda kv: kv[1])
                                       for d in (params, stats))
    print(f"[seg-parity] {tag} train step batch {n} at 96x128, card (f32, TF32 off) vs CPU: "
          f"loss {loss_g:.6f} rel err {loss_err:.3e}; params max rel err {param_err:.3e} "
          f"({pk}); running-stat updates {stat_err:.3e} of the tolerance ({TRAIN_RTOL} of "
          f"the update + 1 ulp of the stat; {sk}); worst five: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stats.items(), key=lambda kv: -kv[1])[:5]),
          flush=True)
    if loss_err > TRAIN_RTOL or failed:
        raise SystemExit(f"chip_smoke: the stage-3 step of {tag} on the card disagrees "
                         f"with the CPU: {failed}")


def bucket_inputs(gen):
    """Two sizes zero-padded into one 128x192 bucket, on the card."""
    sizes = [(120, 185), (97, 150)]
    x = torch.zeros(2, 3, 128, 192, device="cuda")
    for i, (h, w) in enumerate(sizes):
        x[i, :, :h, :w] = torch.randn(3, h, w, generator=gen).cuda()
    return x, torch.tensor(sizes, device="cuda"), sizes


def seg_bucket_vs_exact(tag: str, model, gen):
    """The bucketed eval forward's valid logits against each size's exact
    forward on the card: within 1e-4 of the max."""
    x, valid, sizes = bucket_inputs(gen)
    worst = 0.0
    with torch.inference_mode():
        bucketed = model(x, valid_hw=valid, raw_logits=True)
        for i, (h, w) in enumerate(sizes):
            exact = model(x[i:i + 1, :, :h, :w], raw_logits=True)[0]
            h8, w8 = exact.shape[-2:]
            worst = max(worst, float((bucketed[i, :, :h8, :w8] - exact).abs().max()
                                     / exact.abs().max()))
    print(f"[seg-parity] {tag} bucketed eval (2 sizes in a 128x192 bucket) vs exact on the "
          f"card: valid logits {worst:.3e} of the max (bound 1e-4)", flush=True)
    if not worst <= 1e-4:
        raise SystemExit(f"chip_smoke: {tag} bucketed forward disagrees with exact")


def phase_seg_parity():
    """Stage 3 on the card vs the CPU, same weights, f32 with TF32 off: one
    train-mode step (dropout keep-all) of DeepLab v1 / ResNet-38 at batch 2
    and v2 / ResNet-101 at batch 4, full width, at 96x128; then the bucketed
    eval forward of two sizes in one 64-bucket against each size's exact
    forward, on the card.

    v2 runs at batch 4: its ASPP global branch normalises the pooled
    features over the batch, and at batch 2 some of its 256 channels pool
    to nearly equal values (batch variance < 1e-4, against eps 1e-5), where
    BN divides their difference by ~sqrt(eps) and turns rounding into
    signal: the card and the CPU then differed by up to 2.2e-3 in the
    running-stat update of the conv after it, with parameters within 3e-5."""
    img, lab, gen = seg_parity_inputs()
    for exp, n in (("SEAM_deeplabv1_resnet38", 2), ("EPS_deeplabv2_resnet101", 4)):
        cfg = seg_cfg(exp)
        seg_step_parity(exp, cfg, img[:n], lab[:n])
        model = seg_net(cfg).eval()
        seg_bucket_vs_exact(exp, model, gen)
        del model
        torch.cuda.empty_cache()


def time_steps(step, batch, timed: int):
    """ms a step (mean of `timed` after one warm-up), the last metrics, and
    the peak device memory of the timed steps."""
    step(*batch)  # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        mets = step(*batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed * 1e3, mets, torch.cuda.max_memory_allocated()


def phase_seg_train_working_size(card: str):
    """DeepLab training at the presets' working size, f32 (TF32 off), on
    device-resident random images and labels: SEAM v1 / ResNet-38 at crop
    448, batch 10 (1 + 3 steps and a profiled one), then EPS v2 / ResNet-101
    at crop 448, batch 12 (1 + 3), both on cuDNN's heuristics: the seg_train
    CLI autotunes, but the first step's autotuning takes ~4 minutes (v1) and
    ~2 (v2) on an H100 (PERF.md), which this script's time limit cannot
    hold beside the other phases. Their shapes recur in no later phase, so
    the heuristic plans they cache reach no other reading."""
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    pcm_cuda.reset_launches()
    conv_cuda.reset_launches()
    for exp, timed, autotuned in (("SEAM_deeplabv1_resnet38", 3, False),
                                  ("EPS_deeplabv2_resnet101", 3, False)):
        torch.backends.cudnn.benchmark = autotuned
        cfg = seg_cfg(exp)
        n, crop = cfg.TRAIN_BATCHES, cfg.DATA_RANDOMCROP
        model = seg_net(cfg)
        opt = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                      cfg.TRAIN_WEIGHT_DECAY, cfg.TRAIN_ITERATION + 1, momentum=cfg.TRAIN_MOMENTUM)
        step = make_seg_train_step(model, opt, generator=torch.Generator(device="cuda")
                                   .manual_seed(SEED))
        batch = seg_batch(gen, n, crop)
        t_first = time.perf_counter()
        ms, mets, peak = time_steps(step, batch, timed)
        loss = float(mets["loss"])
        print(f"{card} | seg train {exp} ({cfg.MODEL_NAME}, {cfg.MODEL_BACKBONE}) crop {crop} "
              f"batch {n} f32 (TF32 off), cuDNN {'autotuned' if autotuned else 'heuristics'}: "
              f"{ms:.1f} ms/step, {n / ms * 1e3:.2f} images/s (mean of "
              f"{timed} steps after 1 warm-up; warm-up + timed {time.perf_counter() - t_first:.1f} "
              f"s), peak device memory {peak / 2**30:.2f} GiB; last loss {loss:.4f}", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"chip_smoke: non-finite stage-3 training loss ({exp})")
        if exp == "SEAM_deeplabv1_resnet38":
            totals = profile_kernels(lambda: step(*batch))
            busy = sum(totals.values())
            print(f"{card} | profiled seg train step: device busy {busy:.1f} ms of {ms:.1f} ms "
                  f"a step (idle {100 * max(0.0, 1 - busy / ms):.1f}%); top kernels:")
            print_top(card, totals, k=15)
        del model, opt, step, batch
        torch.cuda.empty_cache()
    print(f"{card} | stage-3 training launched PCM {pcm_cuda.launches} and K2 "
          f"{conv_cuda.launches} times (its convs are cuDNN's, as the JAX nets' are XLA's)",
          flush=True)
    if pcm_cuda.launches or conv_cuda.launches:
        raise SystemExit("chip_smoke: stage 3 unexpectedly launched a port kernel")


def make_seg_root(root: Path, sizes, n_labels: int = 21):
    """A VOC seg root (JPEGImages, SegmentationClass, trainaug / val lists)
    of random images and a pseudo-mask dir beside it; returns (voc root,
    pseudo dir, names). The images are smooth (a 12x16 random grid, bicubic
    upsampled, plus noise of 8 grey levels): the permutohedral CRF's cost
    grows with the colours an image holds, and white noise, unlike a photo,
    fills its lattice."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    voc = root / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (voc / d).mkdir(parents=True)
    (root / "pseudo").mkdir()
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"2007_{i:06d}"
        grid = Image.fromarray((rng.rand(12, 16, 3) * 255).astype(np.uint8))
        img = np.asarray(grid.resize((w, h), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(voc / "JPEGImages" / f"{name}.jpg")
        for folder in (voc / "SegmentationClass", root / "pseudo"):
            lab = rng.randint(0, n_labels, (h, w)).astype(np.uint8)
            lab[:, :4] = 255
            Image.fromarray(lab).save(folder / f"{name}.png")
        names.append(name)
    for lst in ("trainaug.txt", "val.txt"):
        (voc / "ImageSets" / "Segmentation" / lst).write_text("".join(f"{x}\n" for x in names))
    return str(voc), str(root / "pseudo"), names


def tta_inputs(voc: str):
    """(cfg, dataset, chunk of samples, model) of phase 17's images."""
    from wseg_tpu_torch.cli import seg_test
    from wseg_tpu_torch.seg.dataset import generate_dataset

    cfg = seg_cfg("SEAM_deeplabv1_resnet38", DATA_ROOT=voc)
    ds = generate_dataset(cfg, "val")
    chunk = [ds[i] for i in range(seg_test.BATCH)]
    return cfg, ds, chunk, seg_net(cfg).eval()


def tta_device_pass(cfg, chunk, model):
    """seg_test's forward of one chunk, all scales: ([(stride-8 logits,
    view sizes)] a scale, [(bucket shape, forwards)] a scale)."""
    from wseg_tpu_torch.cli import seg_test

    outs, shapes = [], []
    for rate in cfg.TEST_MULTISCALE:
        imgs = [s["image_%f" % rate] for s in chunk]
        batch, valid, cap = seg_test.pad_views(imgs, len(chunk), 2, 64)
        shapes.append((batch.shape[1:3], len(batch) // cap))
        outs.append((seg_test.forward_views(model, batch, valid, cap, "cuda"),
                     [im.shape[:2] for im in imgs]))
    torch.cuda.synchronize()
    return outs, shapes


def phase_seg_test_working_size(card: str):
    """seg_test's TTA at working size: 16 VOC-sized images (375x500 and
    500x375 mixed) in one chunk, bucket 64, 6 scales x flip, f32 (TF32 off),
    through the CLI's own functions: a device pass with the CLI's
    cudnn.benchmark (off: a cold pass read within 1% of a warm one), a
    profiled pass; the host's post-processing per image (upsamples +
    softmax, the native CRF) alone and on the CLI's 4 threads; then the CLI
    end to end on the same images."""
    from concurrent.futures import ThreadPoolExecutor

    from wseg_tpu_torch.cli import seg_test
    from wseg_tpu_torch.ops.densecrf import dense_crf
    from wseg_tpu_torch.utils.checkpoint import save_weights

    base = BUILD_SCRATCH / "seg_tta"
    shutil.rmtree(base, ignore_errors=True)
    n = seg_test.BATCH
    voc, _, names = make_seg_root(base, [(375, 500), (500, 375)] * (n // 2))
    t0 = time.perf_counter()
    cfg, ds, chunk, model = tta_inputs(voc)
    prep_s = time.perf_counter() - t0
    n_flip, n_views = 2, 2 * len(cfg.TEST_MULTISCALE)
    torch.backends.cudnn.benchmark = seg_test.CUDNN_BENCHMARK
    pcm_cuda.reset_launches()
    conv_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, shapes = tta_device_pass(cfg, chunk, model)
    dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"{card} | seg_test TTA chunk of {n} images (375x500 / 500x375), 6 scales x flip, "
          f"bucket 64, f32 (TF32 off); bucket shapes and forwards a scale: "
          + ", ".join(f"{tuple(hw)} x{k}" for hw, k in shapes), flush=True)
    print(f"{card} | device pass (pad + forward + copy back), cudnn.benchmark "
          f"{seg_test.CUDNN_BENCHMARK} as the CLI: {dev_s:.2f} s ({dev_s / n * 1e3:.1f} ms an "
          f"image); peak device memory {peak / 2**30:.2f} GiB; host prep (model, decode + 6 "
          f"cubic resizes of {n} images) {prep_s:.1f} s", flush=True)
    wall0 = time.perf_counter()
    totals = profile_kernels(lambda: tta_device_pass(cfg, chunk, model))
    wall = time.perf_counter() - wall0
    busy = sum(totals.values())
    print(f"{card} | profiled device pass: device busy {busy:.1f} ms ({busy / n:.1f} ms an "
          f"image) of {dev_s * 1e3:.1f} ms unprofiled wall (idle "
          f"{100 * max(0.0, 1 - busy / (dev_s * 1e3)):.1f}%: host padding and copies; "
          f"profiled wall {wall * 1e3:.1f} ms); top kernels:", flush=True)
    print_top(card, totals, k=10)

    def views_of(i):
        views = []
        for logits8, hws in outs:
            vh, vw = hws[i]
            lg8 = logits8[n_flip * i:n_flip * i + n_flip, :-(-vh // 8), :-(-vw // 8)]
            views += [(lg8[j], vh, vw, j == 1) for j in range(n_flip)]
        return views

    t0 = time.perf_counter()
    prob = seg_test.fuse_views(views_of(0), (chunk[0]["row"], chunk[0]["col"]), n_views)
    fuse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    crf = dense_crf(np.ascontiguousarray(prob.transpose(2, 0, 1)), ds.load_image(names[0]))
    crf_s = time.perf_counter() - t0

    def post(i):
        p = seg_test.fuse_views(views_of(i), (chunk[i]["row"], chunk[i]["col"]), n_views)
        return dense_crf(np.ascontiguousarray(p.transpose(2, 0, 1)), ds.load_image(names[i]))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        preds = list(pool.map(post, range(n)))
    pool_s = time.perf_counter() - t0
    if not all(p.shape == (21, c["row"], c["col"]) and np.isfinite(p).all()
               for p, c in zip(preds, chunk)) or crf.shape != preds[0].shape:
        raise SystemExit("chip_smoke: seg_test post-processing gave a wrong shape or NaN")
    print(f"{card} | host post per image, alone: 12 views' two upsamples + softmax "
          f"{fuse_s * 1e3:.1f} ms, native CRF {crf_s * 1e3:.1f} ms; {n} images on the CLI's 4 "
          f"threads {pool_s:.2f} s vs the device pass {dev_s:.2f} s: the "
          f"{'host' if pool_s > dev_s else 'device'} sets the pace ({os.cpu_count()} cores)",
          flush=True)
    del model, outs
    torch.cuda.empty_cache()

    pth = str(base / "seg.pth")
    save_weights(pth, seg_net(cfg, "cpu"))
    out = run_cli(base, seg_test.main, ["--data_root", voc, "--ckpt", pth])
    rate_line = next(line for line in out.splitlines() if "imgs/s end-to-end" in line)
    check_pngs(base / "results" / "Segmentation" / "deeplabv1_val", names,
               [(c["row"], c["col"]) for c in chunk], "seg_test")
    print(f"{card} | seg_test CLI on the same {n} images (one chunk: prep, device and post "
          f"in sequence, CRF on): {rate_line.strip()}", flush=True)
    print(f"{card} | stage-3 testing launched PCM {pcm_cuda.launches} and K2 "
          f"{conv_cuda.launches} times", flush=True)
    if pcm_cuda.launches or conv_cuda.launches:
        raise SystemExit("chip_smoke: stage 3 unexpectedly launched a port kernel")
    shutil.rmtree(base, ignore_errors=True)


def run_cli(cwd: Path, main, argv) -> str:
    """Run a CLI's main in `cwd`, echo its stdout, and return it."""
    import contextlib
    import io

    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    finally:
        os.chdir(old)
    out = buf.getvalue()
    print("\n".join(f"    {line}" for line in out.splitlines()[-6:]), flush=True)
    return out


def phase_seg_cli(card: str):
    """The stage-3 CLI chain on a synthetic seg root from random weights:
    seg_train (a stage-1 contrast state_dict as --backbone_weights, 2
    epochs with --save_state, stopped after one and resumed), then seg_test
    with the native CRF and with --no_crf; every png, the logfile and the
    rate line are checked."""
    from wseg_tpu_torch.cli import seg_test, seg_train
    from wseg_tpu_torch.utils.checkpoint import load_weights, save_weights

    base = BUILD_SCRATCH / "stage3"
    shutil.rmtree(base, ignore_errors=True)
    sizes = [(150, 200), (200, 150), (120, 160), (160, 120)]
    voc, pseudo, names = make_seg_root(base, sizes)
    contrast_pth = str(base / "contrast.pth")
    save_weights(contrast_pth, build_model("contrast", device="cpu",
                                           generator=torch.Generator().manual_seed(SEED)))
    common = ["--data_root", voc, "--pseudo_gt", pseudo, "--iterations", "4", "--batch_size",
              "2", "--crop", "224", "--backbone_weights", contrast_pth]
    t = {}
    t0 = time.perf_counter()
    run_cli(base, seg_train.main, common + ["--save_state", "--stop_after_epoch", "1"])
    run_cli(base, seg_train.main, common + ["--resume",
                                            "model/SEAM_deeplabv1_resnet38/seg_train_state.pth",
                                            "--min_epoch", "1"])
    t["seg_train (1 epoch + a resumed epoch)"] = time.perf_counter() - t0
    pth = str(base / "model" / "SEAM_deeplabv1_resnet38"
              / "deeplabv1_resnet38_VOCDataset_itr4_all.pth")
    sd = load_weights(pth)
    contrast = load_weights(contrast_pth)
    if not all(bool(torch.isfinite(v).all()) for v in sd.values()):
        raise SystemExit("chip_smoke: non-finite weights after seg_train")
    if torch.equal(sd["backbone.b7.conv_branch2a.weight"], contrast["b7.conv_branch2a.weight"]):
        raise SystemExit("chip_smoke: seg_train did not move the loaded backbone")
    for tag, flags in (("CRF", []), ("--no_crf", ["--no_crf"]),
                       ("--crf_backend tpu", ["--crf_backend", "tpu"])):
        d = base / tag.strip("-").replace(" ", "_")
        d.mkdir()
        t0 = time.perf_counter()
        out = run_cli(d, seg_test.main, ["--data_root", voc, "--ckpt", pth, "--batch_size", "4"]
                      + flags)
        t[f"seg_test ({tag})"] = time.perf_counter() - t0
        check_pngs(d / "results" / "Segmentation" / "deeplabv1_val", names, sizes, "seg_test")
        log = (d / "log" / "SEAM_deeplabv1_resnet38" / "logfile.txt").read_text()
        if "mIoU:" not in log or "imgs/s end-to-end" not in out:
            raise SystemExit("chip_smoke: seg_test wrote no eval log or rate line")
    print(f"{card} | stage-3 CLI chain on {len(names)} synthetic images: "
          + "; ".join(f"{k} {v:.1f} s" for k, v in t.items()), flush=True)
    shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# the accelerator CRF (ops/crf.py, --crf_backend tpu)

CRF_QTOL = 1e-3            # max |Q card - Q CPU|
CRF_ARGMAX = 0.999         # argmax agreement, card vs CPU
# argmax agreement with the native CRF, a loose sanity bound: at seg_test's
# parameters the lowrank CRF (the JAX package's algorithm, which the port
# matches within 1e-5) agrees with the exact dense CRF on 94.2-95.1% of the
# pixels of 48x64 smooth synthetic images, the native lattice on 97.6-97.9%
# (tests/test_torch_crf_accel.py), so tests/test_crf_tpu.py's 0.97 for two
# labels does not hold here
CRF_NATIVE_ARGMAX = 0.95


def smooth_image(rng, h: int, w: int, flat: bool = False) -> np.ndarray:
    """A photo-like uint8 image: a 12x16 random colour grid upsampled
    (smooth), or with `flat` four flat colour blocks (sky, walls) and a
    smooth strip."""
    from PIL import Image

    grid = Image.fromarray((rng.rand(12, 16, 3) * 255).astype(np.uint8))
    img = np.asarray(grid.resize((w, h), Image.BICUBIC)).copy()
    if flat:
        for i, colour in enumerate([(200, 220, 250), (120, 120, 120), (60, 140, 40),
                                    (230, 230, 225)]):
            img[: h * 3 // 4, i * w // 4:(i + 1) * w // 4] = colour
    return img


def cam_dict_of(rng, h: int, w: int, n_cls: int = 3) -> dict:
    """A cam dict of `n_cls` classes, as contrast_infer writes: smooth maps
    in [0, 1] (upsampled random grids), zero over about half the image and
    peaking in blobs, as a CAM does."""
    from PIL import Image

    keys = rng.choice(20, n_cls, replace=False)
    cams = {}
    for k in keys:
        g = Image.fromarray((rng.rand(6, 8) * 255).astype(np.uint8))
        g = np.asarray(g.resize((w, h), Image.BICUBIC), np.float32) / 255.0
        cams[int(k)] = np.clip(2 * g - 1, 0, 1)
    return cams


def crf_inputs(rng, h: int, w: int, flat: bool = False):
    """(image, the alpha sweep's 5 seeds, contrast_infer's seed, smooth
    21-class probabilities) of one synthetic image, built as the CLIs build
    them (infer/crf_post.py)."""
    from wseg_tpu_torch.infer import crf_post

    img = smooth_image(rng, h, w, flat)
    cams = cam_dict_of(rng, h, w)
    seeds = np.stack([crf_post._alpha_seed(cams, a) for a in (4, 8, 16, 24, 32)])
    scores = crf_post._scores(cams)
    scores[0] = 0.26
    seed = np.argmax(scores, axis=0).astype(np.uint8)
    # smooth at the pixel scale, as seg_test's are (stride-8 logits upsampled
    # and averaged over 12 views); per-pixel logit noise of 0.5 made near-ties
    # that the lowrank and the lattice CRF broke apart on 4% of the pixels
    logits = scores * 6
    e = np.exp(logits - logits.max(0, keepdims=True))
    return img, seeds, seed, np.ascontiguousarray(e / e.sum(0, keepdims=True), np.float32)


def crf_calls(method: str = "lowrank"):
    """The three CRF calls of the CLIs, by name: (function of (inputs,
    device) -> Q, the native CRF's function of inputs -> Q)."""
    from wseg_tpu_torch.infer.crf_post import AFF_CRF_PARAMS, CAM_CRF_PARAMS
    from wseg_tpu_torch.ops import crf
    from wseg_tpu_torch.ops.densecrf import (
        crf_inference_labels, crf_inference_labels_multi, dense_crf,
    )

    def seg(inp, device):
        if method == "lowrank":
            return crf.dense_crf_tpu(inp[3], inp[0], device=device)
        return crf.crf_softmax_tpu(inp[0], inp[3], t=1, method=method, device=device,
                                   sxy_gaussian=3, compat_gaussian=3, sxy_bilateral=32,
                                   srgb=13, compat_bilateral=10)

    return {
        "aff_prepare sweep (A 5, t 10, sxy 80 / srgb 13)": (
            lambda inp, dev: crf.crf_labels_tpu_batch(inp[0], inp[1], t=10, method=method,
                                                      device=dev, **AFF_CRF_PARAMS),
            lambda inp: crf_inference_labels_multi(inp[0], inp[1], t=10, **AFF_CRF_PARAMS)),
        "contrast_infer (t 10, sxy 50 / srgb 5)": (
            lambda inp, dev: crf.crf_labels_tpu(inp[0], inp[2], t=10, method=method,
                                                device=dev, **CAM_CRF_PARAMS),
            lambda inp: crf_inference_labels(inp[0], inp[2], t=10, **CAM_CRF_PARAMS)),
        "seg_test dense_crf (t 1, sxy 32 / srgb 13)": (
            seg, lambda inp: dense_crf(inp[3], inp[0])),
    }


def crf_parity(card: str):
    """(a): the port's CRF on the card against the same call on the CPU at
    128x160 x 21 labels, the CLIs' three calls: both methods on a smooth
    image, the lowrank one on an image with flat regions. Max |dQ| and
    argmax agreement are gated; the agreement with the native CRF is
    printed and gated loosely."""
    rng = np.random.RandomState(SEED + 19)
    worst_q, worst_arg, worst_native = 0.0, 1.0, 1.0
    for flat in (False, True):
        inp = crf_inputs(rng, 128, 160, flat)
        # the flat image is the Nystrom eigh's hard case; the grid has no eigh
        for method in ("lowrank",) if flat else ("lowrank", "grid"):
            for name, (fn, native_fn) in crf_calls(method).items():
                got, want = fn(inp, "cuda"), fn(inp, "cpu")
                dq = float(np.abs(got - want).max())
                axis = got.ndim - 3
                agree = float((got.argmax(axis) == want.argmax(axis)).mean())
                native = float((got.argmax(axis) == native_fn(inp).argmax(axis)).mean())
                worst_q, worst_arg = max(worst_q, dq), min(worst_arg, agree)
                worst_native = min(worst_native, native)
                print(f"{card} | CRF parity {'flat' if flat else 'smooth'} 128x160 {method} "
                      f"{name}: max |dQ| card vs CPU {dq:.2e}, argmax agreement {agree:.5f}; "
                      f"with the native CRF {native:.4f}", flush=True)
    if worst_q > CRF_QTOL or worst_arg < CRF_ARGMAX or worst_native < CRF_NATIVE_ARGMAX:
        raise SystemExit(f"chip_smoke: accelerator CRF parity failed: max |dQ| {worst_q:.2e} "
                         f"(<= {CRF_QTOL}), argmax {worst_arg:.5f} (>= {CRF_ARGMAX}), native "
                         f"{worst_native:.4f} (>= {CRF_NATIVE_ARGMAX})")


CRF_NATIVE_IMAGES = 4  # of the 16: the native CRF's host seconds are read on these


def crf_working_size(card: str):
    """(b): the CLIs' three CRF calls on phase 17's 16 smooth VOC-sized
    images (375x500 / 500x375, buckets 384x512 / 512x384): ms an image of
    the card's timeline (CUDA events around each call) and of the wall,
    peak memory, one profiled image's top kernels, and the native CRF's
    host seconds an image on the first CRF_NATIVE_IMAGES of them."""
    rng = np.random.RandomState(SEED + 17)
    sizes = [(375, 500), (500, 375)] * 8
    inputs = [crf_inputs(rng, h, w) for h, w in sizes]
    for name, (fn, native_fn) in crf_calls().items():
        fn(inputs[0], "cuda")
        fn(inputs[1], "cuda")  # both buckets' factors built, the allocator warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev_ms, t0 = 0.0, time.perf_counter()
        for inp in inputs:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            q = fn(inp, "cuda")
            end.record()
            end.synchronize()
            ev_ms += start.elapsed_time(end)
            if not np.isfinite(q).all():
                raise SystemExit(f"chip_smoke: non-finite CRF output ({name})")
        wall = (time.perf_counter() - t0) / len(inputs)
        peak = torch.cuda.max_memory_allocated()
        totals = profile_kernels(lambda: fn(inputs[0], "cuda"))
        busy = sum(totals.values())
        t0 = time.perf_counter()
        for inp in inputs[:CRF_NATIVE_IMAGES]:
            native_fn(inp)
        native_s = (time.perf_counter() - t0) / CRF_NATIVE_IMAGES
        print(f"{card} | CRF at working size, {name}: {ev_ms / len(inputs):.1f} ms an image "
              f"on the card's timeline (CUDA events), {wall * 1e3:.1f} ms of wall; one "
              f"profiled 375x500 image busy {busy:.1f} ms; peak device memory "
              f"{peak / 2**30:.2f} GiB; native CRF {native_s:.3f} host s an image (1 thread, "
              f"{CRF_NATIVE_IMAGES} of the {len(inputs)} images)", flush=True)
        print_top(card, totals, k=6)


def phase_crf(card: str):
    """19. The accelerator CRF (ops/crf.py): (a) card vs CPU parity, (b) the
    working size against the native CRF. (c), its CLIs, runs in phases 14
    and 18. TF32 stays off for its matmuls; no port kernel launches."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: TF32 is on for the CRF's matmuls")
    pcm_cuda.reset_launches()
    conv_cuda.reset_launches()
    crf_parity(card)
    crf_working_size(card)
    if pcm_cuda.launches or conv_cuda.launches:
        raise SystemExit("chip_smoke: the CRF unexpectedly launched a port kernel")


# ---------------------------------------------------------------------------
# the bench twin, SEAMNet, and the rest of stage 3

BENCH_ITERS, BENCH_BASELINE_REPS = 3, 1  # bench's defaults are 8 and 12: cut for time


@contextlib.contextmanager
def pcm_calls_on_path():
    """Record the inputs that the code run inside gives pcm_cuda.pcm_fused
    (the NCHW wrapper calls it too), the first of each shape and dtype:
    yields {key: (cam, f, eps, mask)}. The call itself runs and counts as
    before."""
    seen, launch = {}, pcm_cuda.pcm_fused

    def record(cam, f, eps=1e-5, mask=None, variant=None):
        key = (tuple(f.shape), f.dtype, cam.dtype, mask is not None)
        if key not in seen:
            seen[key] = (cam.detach().clone(), f.detach().clone(), eps,
                         None if mask is None else mask.detach().clone())
        return launch(cam, f, eps, mask, variant)

    pcm_cuda.pcm_fused = record
    try:
        yield seen
    finally:
        pcm_cuda.pcm_fused = launch


def hold_pcm_on_path(tag: str, seen: dict) -> float:
    """The PCM kernel against its plain twin (pcm_flat_bf16 for bf16
    features, pcm_flat for f32) on each recorded input, within phase 3's
    tolerance: the max abs error. The cam goes in as f32, which is what the
    kernel reads whatever its dtype (a bf16 cam's output is rounded to bf16
    after the kernel, which no plain twin repeats)."""
    worst = 0.0
    for (shape, f_dtype, cam_dtype, masked), (cam, f, eps, mask) in seen.items():
        variant = pcm_cuda.pcm_variant(f_dtype, shape[2])
        plain = pcm_flat_bf16 if f_dtype == torch.bfloat16 else pcm_flat
        got = pcm_cuda.pcm_fused(cam.float(), f, eps, mask)
        want = plain(cam.float(), f, eps, mask)
        err = (got - want).abs()
        ok = bool((err <= ATOL + RTOL * want.abs()).all())
        worst = max(worst, float(err.max()))
        print(f"[kernel-on-path] {tag}: f {shape} {str(f_dtype)[6:]}, cam {str(cam_dtype)[6:]}"
              f"{', masked' if masked else ''}, variant {variant}: max_abs_err "
              f"{float(err.max()):.3e} within rtol={RTOL} atol={ATOL}: {ok}", flush=True)
        del got, want, err
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"chip_smoke: PCM kernel disagrees with its plain version on "
                             f"{tag}'s inputs {shape}")
    return worst


def run_bench(argv) -> dict:
    """cli/bench.py's main in this process: its one JSON line, echoed and
    checked (value > 0)."""
    from wseg_tpu_torch.cli import bench

    out = run_cli(Path.cwd(), bench.main, argv)
    lines = [line for line in out.splitlines() if line.strip()]
    if len(lines) != 1:
        raise SystemExit(f"chip_smoke: bench printed {len(lines)} stdout lines, not one JSON line")
    result = json.loads(lines[0])
    if not result["value"] > 0:
        raise SystemExit(f"chip_smoke: bench {argv} gave value {result['value']}")
    return result


def phase_bench(card: str) -> dict:
    """The bench twin at its defaults (384x512, batch 8, bf16 trunk) with
    `iters` and `baseline_reps` cut for time, then `--mode train` in f32 at
    crop 448, batch 8; then one profiled fused-only cam run. Returns the PCM
    launches of the unprofiled cam run by path: the fused bf16 path's
    tensor-core kernel, the f32 reference-style baseline's FMA kernel."""
    print(f"[bench] cam mode with --iters {BENCH_ITERS} --baseline_reps {BENCH_BASELINE_REPS} "
          "(defaults 8 and 12, cut for this script's time)", flush=True)
    pcm_cuda.reset_launches()
    with pcm_calls_on_path() as seen:
        cam = run_bench(["--mode", "cam", "--iters", str(BENCH_ITERS), "--baseline_reps",
                         str(BENCH_BASELINE_REPS)])
    mma, fma = pcm_cuda.variant_launches["mma"], pcm_cuda.variant_launches["fma"]
    if cam["vs_baseline"] is None or not cam["vs_baseline"] > 0:
        raise SystemExit("chip_smoke: bench --mode cam gave no vs_baseline")
    if mma < 1 or fma < 1 or mma + fma != pcm_cuda.launches:
        raise SystemExit(f"chip_smoke: bench --mode cam launched {mma} tensor-core and {fma} "
                         f"FMA PCM kernels of {pcm_cuda.launches} PCM launches")
    hold_pcm_on_path("bench --mode cam", seen)
    del seen
    totals = profile_kernels(lambda: run_bench(["--mode", "cam", "--iters", "1", "--warmup", "0",
                                                "--skip_reference_style"]))
    pcm_ms = sum(v for k, v in totals.items() if PCM_KERNEL_NAME in k)
    if not pcm_ms > 0:
        raise SystemExit(f"chip_smoke: torch.profiler saw no {PCM_KERNEL_NAME} in bench's cam run")
    train = run_bench(["--mode", "train", "--dtype", "float32", "--iters", "2", "--warmup", "1"])
    d = cam["detail"]
    print(f"{card} | bench cam: {cam['value']} images/s, vs_baseline {cam['vs_baseline']} "
          f"(reference-style {d['reference_style_ips']} images/s); ceiling "
          f"{d['physical_ceiling_ips']} images/s ({d['pct_of_physical_ceiling']}%); PCM "
          f"launches: {mma} tensor-core on the fused path ({d['pcm_launches_per_batch']} a "
          f"timed batch), {fma} FMA on the f32 baseline; profiled {PCM_KERNEL_NAME} "
          f"{pcm_ms:.2f} ms; bench train f32: {train['value']} images/s", flush=True)
    torch.cuda.empty_cache()
    return {"bench --mode cam, fused bf16 (phase 20)": mma,
            "bench --mode cam, reference-style f32 (phase 20)": fma}


def phase_seam(card: str) -> int:
    """SEAMNet: the full-width net on the card (PCM kernel, f32, TF32 off)
    against the same weights on the CPU (plain PCM) at 2 x 64x96: cam_rv,
    the PCM-refined CAM in [0, 1], within SLICE_ATOL absolutely; cam, the
    raw fc8 logits of a random net (O(100)), within SEAM_CAM_RTOL of its
    largest entry. Then a forward at crop 448, batch 8, bf16 trunk: ms,
    peak memory and the PCM launches, and the tensor-core kernel against
    its plain twin on the inputs that forward gave it. Returns the launches
    of the timed crop-448 forwards."""
    gen = torch.Generator().manual_seed(SEED + 20)
    x = torch.randn(2, 3, 64, 96, generator=gen)
    outs = {}
    pcm_cuda.reset_launches()
    for dev in ("cpu", "cuda"):
        model = build_model("seam", device=dev, generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            outs[dev] = [t.cpu() for t in model.eval()(x.to(dev))]
        del model
    fma = pcm_cuda.variant_launches["fma"]
    (cam_g, rv_g), (cam_c, rv_c) = outs["cuda"], outs["cpu"]
    cam_abs, rv_err = float((cam_g - cam_c).abs().max()), float((rv_g - rv_c).abs().max())
    cam_max = float(cam_c.abs().max())
    print(f"[seam-parity] SEAMNet (cam, cam_rv) {tuple(cam_g.shape)} card (kernel, f32, TF32 "
          f"off) vs CPU (plain PCM): cam max_abs_err {cam_abs:.3e} of max |cam| {cam_max:.3e} "
          f"(rel {cam_abs / cam_max:.3e}, bound {SEAM_CAM_RTOL}); cam_rv max_abs_err "
          f"{rv_err:.3e} (bound {SLICE_ATOL}); f32 PCM launches {fma}", flush=True)
    if fma != 1 or pcm_cuda.launches != 1:
        raise SystemExit(f"chip_smoke: SEAMNet launched {pcm_cuda.launches} PCM kernels, "
                         f"{fma} f32, not 1")
    if not (cam_abs <= SEAM_CAM_RTOL * cam_max and rv_err <= SLICE_ATOL):
        raise SystemExit("chip_smoke: SEAMNet on the card disagrees with the CPU")

    n, crop = 8, 448
    model = build_model("seam", generator=torch.Generator().manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    img = torch.randn(n, 3, crop, crop, generator=torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda").to(torch.bfloat16)
    img = img.contiguous(memory_format=torch.channels_last)

    def fwd():
        with torch.no_grad():
            return model(img)

    with pcm_calls_on_path() as seen:
        out = fwd()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pcm_cuda.reset_launches()
    ms = cuda_ms(fwd, iters=3, warmup=0)
    launches = pcm_cuda.variant_launches["mma"]
    peak = torch.cuda.max_memory_allocated()
    if launches != 3 or pcm_cuda.launches != 3:
        raise SystemExit(f"chip_smoke: 3 SEAMNet forwards launched {launches} tensor-core PCM "
                         f"kernels of {pcm_cuda.launches}")
    if not all(bool(torch.isfinite(t).all()) and t.shape == (n, 21, crop, crop) for t in out):
        raise SystemExit("chip_smoke: SEAMNet gave a wrong shape or non-finite values")
    hold_pcm_on_path(f"SEAMNet crop {crop} batch {n} bf16", seen)
    del seen
    totals = profile_kernels(fwd)
    busy = sum(totals.values())
    pcm_ms = sum(v for k, v in totals.items() if any(m in k for m in PCM_KERNEL_NAMES))
    print(f"{card} | SEAMNet forward crop {crop} batch {n} bf16 trunk: {ms:.1f} ms "
          f"({n / ms * 1e3:.2f} images/s, CUDA events, mean of 3), peak device memory "
          f"{peak / 2**30:.2f} GiB, PCM launches {launches} ({launches // 3} a forward); profiled: "
          f"busy {busy:.1f} ms, PCM kernels {pcm_ms:.2f} ms ({100 * pcm_ms / busy:.2f}%)",
          flush=True)
    del model, out, img
    torch.cuda.empty_cache()
    return launches


def v3plus_cfg():
    """DeepLab v3+ on Xception (os 8) with the SegConfig defaults."""
    from wseg_tpu_torch.seg.config import SegConfig

    return SegConfig(MODEL_NAME="deeplabv3plus", MODEL_BACKBONE="xception")


def phase_seg_nets(card: str):
    """The new stage-3 nets. Parity, card vs CPU as phase 15: one train-mode
    step (dropout off, 96x128) of v1-caffe / ResNet-38 at batch 2, v3 /
    ResNet-101 at batch 4 and v3+ / Xception (os 8) at batch 4. Then v3+ /
    Xception at the SegConfig defaults (crop 448, batch 10), f32, on cuDNN's
    heuristics: ms a step, images/s, peak memory, device busy and a profiled
    step's top kernels. Then a bucketed eval forward of v3 (against exact)
    and of v3+ (card against CPU). Neither K1 nor K2 may launch."""
    from wseg_tpu_torch.seg.config import SegConfig
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    pcm_cuda.reset_launches()
    conv_cuda.reset_launches()
    img, lab, gen = seg_parity_inputs()
    v1c = SegConfig(MODEL_NAME="deeplabv1_caffe")
    v3 = SegConfig(MODEL_NAME="deeplabv3", MODEL_BACKBONE="resnet101", MODEL_ASPP_HASGLOBAL=True)
    for tag, cfg, n in (("deeplabv1_caffe / resnet38", v1c, 2),
                        ("deeplabv3 / resnet101", v3, 4),
                        ("deeplabv3plus / xception", v3plus_cfg(), 4)):
        seg_step_parity(tag, cfg, img[:n], lab[:n], f64_referee=True)
        torch.cuda.empty_cache()

    torch.backends.cudnn.benchmark = False
    cfg = v3plus_cfg()
    n, crop = cfg.TRAIN_BATCHES, cfg.DATA_RANDOMCROP
    model = seg_net(cfg)
    opt = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                  cfg.TRAIN_WEIGHT_DECAY, cfg.TRAIN_ITERATION + 1, momentum=cfg.TRAIN_MOMENTUM)
    step = make_seg_train_step(model, opt, generator=torch.Generator(device="cuda")
                               .manual_seed(SEED))
    batch = seg_batch(torch.Generator(device="cuda").manual_seed(SEED + 21), n, crop)
    ms, mets, peak = time_steps(step, batch, 2)
    loss = float(mets["loss"])
    if not np.isfinite(loss):
        raise SystemExit("chip_smoke: non-finite v3+ / Xception training loss")
    totals = profile_kernels(lambda: step(*batch))
    busy = sum(totals.values())
    print(f"{card} | seg train deeplabv3plus / xception (os 8) crop {crop} batch {n} f32 (TF32 "
          f"off), cuDNN heuristics: {ms:.1f} ms/step, {n / ms * 1e3:.2f} images/s (mean of 2 "
          f"after 1 warm-up), peak device memory {peak / 2**30:.2f} GiB; last loss {loss:.4f}; "
          f"profiled step: device busy {busy:.1f} ms (idle "
          f"{100 * max(0.0, 1 - busy / ms):.1f}%); top kernels:", flush=True)
    print_top(card, totals, k=10)
    del model, opt, step, batch
    torch.cuda.empty_cache()

    model = seg_net(v3).eval()
    seg_bucket_vs_exact("deeplabv3 / resnet101", model, gen)
    del model
    x, valid, _ = bucket_inputs(gen)
    outs = []
    for dev in ("cuda", "cpu"):
        model = seg_net(v3plus_cfg(), dev).eval()
        with torch.inference_mode():
            outs.append(model(x.to(dev), valid_hw=valid.to(dev), raw_logits=True).cpu())
        del model
    err = rel_err(outs[0], outs[1])
    print(f"[seg-nets] deeplabv3plus / xception bucketed eval (2 sizes in a 128x192 bucket), "
          f"card vs CPU: {err:.3e} of the max (bound {TRAIN_RTOL})", flush=True)
    if not err <= TRAIN_RTOL:
        raise SystemExit("chip_smoke: the bucketed v3+ forward on the card disagrees with the CPU")
    print(f"{card} | the new stage-3 nets launched PCM {pcm_cuda.launches} and K2 "
          f"{conv_cuda.launches} times", flush=True)
    if pcm_cuda.launches or conv_cuda.launches:
        raise SystemExit("chip_smoke: stage 3 unexpectedly launched a port kernel")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# data parallelism on the card

# phase 23's gates, a step with a NCCL group of world size 1 against the same
# step without one. Measured on an H100 80GB HBM3 at 700 W (PERF.md): metrics
# equal; parameters <= 1.24e-6 of their max (stage 3's global-moment BN;
# stages 1 and 2 <= 7.3e-8, cuDNN's backward); stage 3's running-stat
# updates 4.08e-4 of their max, the float32 rounding of momentum-3e-4
# updates, within one ulp of the stat.
DP_LOSS_RTOL = 1e-6    # every metric, relative
DP_PARAM_RTOL = 1e-5   # every parameter, of its tensor's largest entry
DP_STATS_RTOL = 1e-4   # stage 3's running-stat updates, of their largest, plus 1 ulp


def dp_step(kind: str, group) -> tuple[dict, dict, dict]:
    """One train step of trainer `kind` on the card at a small crop, with
    `group` (None: without one), dropout on, weights and draws from SEED:
    (metrics, state_dict before, state_dict after), on the CPU."""
    from wseg_tpu_torch.train.affinity import make_aff_train_step
    from wseg_tpu_torch.train.optim import seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    rng = np.random.RandomState(SEED + 23)
    steps = torch.Generator(device="cuda").manual_seed(SEED + 23)
    if kind == "contrast":
        model = build_model("contrast", generator=torch.Generator().manual_seed(SEED))
        opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
        step = make_train_step(model, opt, 0.2, low_res=32, grad_clip=5.0, generator=steps,
                               group=group)
        label = torch.zeros(2, 20)
        label[0, 2] = label[1, [6, 11, 14]] = 1
        batch = (torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32) * 0.5), label)
    elif kind == "affinity":
        model = spread_affinities(build_model("affinity",
                                              generator=torch.Generator().manual_seed(SEED)))
        opt = PolySGD(param_groups(model), 1e-3, 5e-4, 100)
        step = make_aff_train_step(model, opt, generator=steps, group=group)
        batch = (torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32) * 0.5),
                 *aff_targets(rng, 2, 8))
    else:
        cfg = seg_cfg("SEAM_deeplabv1_resnet38")
        model = seg_net(cfg)
        opt = PolySGD(param_groups(model, seg_label_params(model)), cfg.TRAIN_LR,
                     cfg.TRAIN_WEIGHT_DECAY, cfg.TRAIN_ITERATION + 1, momentum=0.9)
        step = make_seg_train_step(model, opt, generator=steps, group=group)
        img, lab, _ = seg_parity_inputs()
        batch = (img[:2], lab[:2])
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    mets = step(*(t.cuda() for t in batch))
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, opt, step
    torch.cuda.empty_cache()
    return {k: float(v) for k, v in mets.items() if k != "pred"}, before, after


def dp_inference_items(n: int = BATCH):
    """n images' MSF views at 384x512 (4 scales x flip, normalised noise) and
    labels, as CamInferencer.infer_batch takes them."""
    rng = np.random.RandomState(SEED + 24)
    items = []
    for i in range(n):
        views = []
        for s in SCALES:
            v = rng.randn(round(H0 * s), round(W0 * s), 3).astype(np.float32)
            views += [v, v[:, ::-1].copy()]
        lab = np.zeros(20, np.float32)
        lab[[i % 20, (3 * i + 7) % 20]] = 1.0
        items.append((views, lab, (H0, W0)))
    return items


def dp_miou_inputs(root: Path) -> tuple[str, str, list]:
    """4 predicted and ground-truth pngs at 384x512 (255 on some pixels)."""
    from PIL import Image

    rng = np.random.RandomState(SEED + 26)
    pred, gt = root / "pred", root / "gt"
    shutil.rmtree(root, ignore_errors=True)
    pred.mkdir(parents=True)
    gt.mkdir()
    names = [f"im{i}" for i in range(4)]
    for name in names:
        g = rng.choice([0, 3, 8, 15, 255], size=(H0, W0)).astype(np.uint8)
        p = np.where(rng.rand(H0, W0) < 0.7, g, rng.choice([0, 3, 8], size=(H0, W0)))
        Image.fromarray(g).save(gt / f"{name}.png")
        Image.fromarray(np.where(g == 255, 0, p).astype(np.uint8)).save(pred / f"{name}.png")
    return str(pred), str(gt), names


def dp_torchrun_join(card: str):
    """Phase 23's second group, joined as the six CLIs join under torchrun:
    RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT (port 0: the
    kernel picks a free one) in the environment, then
    parallel/mesh.py:joined(resolve_device("cuda")). It must be NCCL (no
    fallback) on the LOCAL_RANK'th card; the training group for a batch of
    8 is the world; seg_test's mIoU reduction (all_reduce_array through the
    card) equals the one without a group; the group is gone after the
    `with` block."""
    import torch.distributed as dist

    from wseg_tpu_torch.eval.miou import do_python_eval
    from wseg_tpu_torch.parallel.mesh import group_for_batch, joined
    from wseg_tpu_torch.utils.device import resolve_device

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT="0")
    saved = {k: os.environ.get(k) for k in env}
    pred, gt, names = dp_miou_inputs(BUILD_SCRATCH / "dp_miou")
    with contextlib.redirect_stdout(io.StringIO()):
        want = do_python_eval(pred, gt, names)
    os.environ.update(env)
    try:
        device = resolve_device("cuda")
        with joined(device) as world:
            backend, current = dist.get_backend(world), torch.cuda.current_device()
            sub, trains = group_for_batch(BATCH, world)
            with contextlib.redirect_stdout(io.StringIO()):
                got = do_python_eval(pred, gt, names, group=sub)
        left = not dist.is_initialized()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"{card} | [data-parallel] torchrun environment (RANK 0, WORLD_SIZE 1, LOCAL_RANK 0): "
          f"joined {backend} on {device} (current device {current}), training group for "
          f"batch {BATCH} is the world: {sub is world and trains}, mIoU over the group "
          f"{got['mIoU']:.4f} vs {want['mIoU']:.4f} without, group left: {left}", flush=True)
    if not (backend == "nccl" and device == torch.device("cuda", 0) and current == 0
            and sub is world and trains and got == want and left):
        raise SystemExit("chip_smoke: joining from the torchrun environment went wrong")


def phase_data_parallel(card: str) -> int:
    """Phase 23: the data-parallel code path on the card in a NCCL group of
    world size 1: over a file store (no port), a step of each trainer, the
    data-parallel CamInferencer and pcm_spatial; then a group joined from
    torchrun's environment (dp_torchrun_join). Returns K1's launches on the
    data-parallel CamInferencer path."""
    import torch.distributed as dist

    from wseg_tpu_torch.parallel.mesh import shard_indices
    from wseg_tpu_torch.parallel.spatial import pcm_spatial

    store = BUILD_SCRATCH / "dp_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    # NCCL failing here is an error of this phase: nothing falls back to gloo
    dist.init_process_group("nccl", init_method=store.as_uri(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            raise SystemExit(f"chip_smoke: the group's backend is {dist.get_backend(group)}")
        for kind in ("contrast", "affinity", "seg"):
            (m0, init, s0), (m1, _, s1) = dp_step(kind, None), dp_step(kind, group)
            loss_err = max(abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-30) for k in m0)
            params = [k for k in s0 if s0[k].is_floating_point()
                      and not k.endswith(("running_mean", "running_var"))]
            param_err = max(rel_err(s1[k], s0[k]) for k in params)
            moved = sum(not torch.equal(s1[k], init[k]) for k in params)
            stats = [k for k in s0 if k.endswith(("running_mean", "running_var"))]
            stat_frac, stats_ok = 0.0, True  # the largest stat error over its bound
            if kind == "seg":
                for k in stats:
                    du, dw = s1[k] - init[k], s0[k] - init[k]
                    bound = DP_STATS_RTOL * float(dw.abs().max()) + float(
                        np.spacing(np.float32(s0[k].abs().max())))
                    stat_frac = max(stat_frac, float((du - dw).abs().max()) / bound)
                    stats_ok &= float(dw.abs().max()) > 0
                stats_ok &= stat_frac <= 1.0
            else:
                stats_ok = all(torch.equal(s1[k], s0[k]) for k in stats)
            print(f"[data-parallel] {kind} step, NCCL group of 1 vs no group (f32, TF32 off, "
                  f"dropout on): loss {m1['loss']:.6f} vs {m0['loss']:.6f}, metrics max rel err "
                  f"{loss_err:.3e} (bound {DP_LOSS_RTOL}); {len(params)} parameters ({moved} "
                  f"moved) max rel err {param_err:.3e} (bound {DP_PARAM_RTOL}); "
                  f"{len(stats)} running stats" + (f", updates within {stat_frac:.3f} of "
                                                   f"their bound ({DP_STATS_RTOL} of their "
                                                   "max + 1 ulp)"
                                                   if kind == "seg" else " unchanged, equal"),
                  flush=True)
            if not (loss_err <= DP_LOSS_RTOL and param_err <= DP_PARAM_RTOL and stats_ok
                    and moved > 0):
                raise SystemExit(f"chip_smoke: the data-parallel {kind} step disagrees with "
                                 "the step without a group")

        model = build_model("contrast", generator=torch.Generator().manual_seed(SEED)).eval()
        items = dp_inference_items()
        want = CamInferencer(model).infer_batch(items)
        inferencer = CamInferencer(model, group=group)
        pcm_cuda.reset_launches()
        with pcm_calls_on_path() as seen:
            t0 = time.perf_counter()
            got = inferencer.infer_batch([items[i] for i in shard_indices(len(items), group)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches, fma = pcm_cuda.launches, pcm_cuda.variant_launches["fma"]
        if launches < 1 or len(got) != len(items):
            raise SystemExit(f"chip_smoke: data-parallel CamInferencer launched {launches} PCM "
                             f"kernels for {len(got)} of {len(items)} images")
        for g, w in zip(got, want):
            check_fused(torch.from_numpy(g), (20, H0, W0))
            if not np.array_equal(g, w):
                raise SystemExit("chip_smoke: data-parallel CamInferencer's cams differ from "
                                 "the ones without a group")
        err = hold_pcm_on_path("data-parallel CamInferencer f32", seen)
        del seen, model, inferencer
        torch.cuda.empty_cache()
        print(f"{card} | data-parallel CamInferencer (NCCL group of 1), {len(items)} images "
              f"384x512, 4 scales x flip, f32: {dt:.2f} s, PCM launches {launches} "
              f"({fma} f32 FMA), cams equal to no group, K1 max abs err {err:.3e}", flush=True)

        gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        cam = torch.rand(2, 3072, 21, generator=gen, device="cuda")
        f = torch.randn(2, 3072, 192, generator=gen, device="cuda")
        got, want = pcm_spatial(cam, f, group), pcm_flat(cam, f)
        ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5))
        print(f"[data-parallel] pcm_spatial (NCCL group of 1) vs ops/pcm.py pcm_flat at (2, "
              f"3072, 192) f32: max abs err {float((got - want).abs().max()):.3e} within rtol "
              f"1e-4 atol 1e-5: {ok}", flush=True)
        if not ok:
            raise SystemExit("chip_smoke: pcm_spatial disagrees with the dense PCM")
    finally:
        dist.destroy_process_group()
    dp_torchrun_join(card)
    return launches


def timed(name: str, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    timed("2 build", phase_build)
    pcm_row = timed("3 PCM vs plain", phase_kernel_vs_plain, name)
    timed("4 slice parity", phase_slice_parity)
    pcm_row["launches"] = timed("5 CAM inference", phase_working_size, card)
    conv_row = timed("6 conv vs plain", phase_conv_vs_plain, name, card)
    conv_row["launches"] = timed("7 conv probe", phase_conv_probe, card)
    timed("8 train parity", phase_train_parity)
    timed("9 training", phase_train_working_size, card)
    timed("10 training CLI", phase_train_cli, card)
    timed("11 stage-2 parity", phase_stage2_parity)
    timed("12 random walk", phase_rw_working_size, card)
    timed("13 AffinityNet training", phase_aff_train_working_size, card)
    timed("14 stage-2 CLI chain", phase_stage2_cli, card)
    timed("15 stage-3 parity", phase_seg_parity)
    timed("16 seg training", phase_seg_train_working_size, card)
    timed("17 seg_test TTA", phase_seg_test_working_size, card)
    timed("18 stage-3 CLI chain", phase_seg_cli, card)
    timed("19 accelerator CRF", phase_crf, card)
    by_path = {"CAM inference (phase 5)": pcm_row["launches"]}
    by_path.update(timed("20 bench twin", phase_bench, card))
    by_path["SEAMNet forward (phase 21)"] = timed("21 SEAMNet", phase_seam, card)
    timed("22 stage-3 nets", phase_seg_nets, card)
    by_path["data-parallel CamInferencer, f32 (phase 23)"] = timed(
        "23 data parallel", phase_data_parallel, card)
    pcm_row["launches"] = sum(by_path.values())
    pcm_row["launches_by_path"] = by_path
    print(f"[time] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [pcm_row, conv_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
