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
     train state, then a --resume'd second epoch.
The second-to-last lines are the kernel table as JSON and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.
Weights are random, from a seed; nothing is downloaded.
"""

from __future__ import annotations

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
from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain
from wseg_tpu_torch.ops.pcm import pcm_flat, pcm_flat_bf16
from wseg_tpu_torch.train.contrast import make_train_step
from wseg_tpu_torch.train.optim import PolySGD, param_groups

SEED = 0
RTOL, ATOL = 2e-3, 2e-4          # the kernel's tolerance (tests/test_pcm_pallas.py)
SLICE_ATOL = 1e-3                # fused CAM, card (kernel) vs CPU (plain)
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
    lies in [0, 1] wherever it is not the per-map floor that the reference's
    normalization gives pixels below min + e."""
    if tuple(out.shape) != shape:
        raise SystemExit(f"chip_smoke: output shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("chip_smoke: non-finite values in the fused CAM")
    floor = out.amin(dim=(-2, -1), keepdim=True)
    if not bool(((out <= 1.0) & ((out >= 0.0) | (out == floor))).all()):
        raise SystemExit("chip_smoke: fused CAM outside [0, 1] beyond the per-map floor")


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
        if isinstance(m, Dropout2d):
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


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    phase_build()
    pcm_row = phase_kernel_vs_plain(name)
    phase_slice_parity()
    pcm_row["launches"] = phase_working_size(card)
    conv_row = phase_conv_vs_plain(name, card)
    conv_row["launches"] = phase_conv_probe(card)
    phase_train_parity()
    phase_train_working_size(card)
    phase_train_cli(card)
    print(json.dumps({"kernels": [pcm_row, conv_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
