"""GPU smoke run of the PyTorch/CUDA port (wseg_tpu_torch) on one H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card of compute capability 9.0; prints nvidia-smi's name
     and power limit;
  2. build: every CUDA kernel of the port, from kernels/csrc, nvcc in parallel;
  3. kernel vs plain: the PCM kernel against its plain PyTorch version on the
     card (f32, TF32 off) at the scale-2 pair of a 384x512 image, a hw tail
     (700), a masked case, and the main path's own shape with bf16 features;
  4. slice parity: the full-width ContrastNet through make_fused_msf_fn at
     64x96 on the card (kernel, f32, TF32 off) against the same weights on the
     CPU (plain PCM);
  5. slice at working size: make_fused_msf_fn at 384x512, 4 scales x flip,
     batch 8, bf16 trunk and f32 fusion, under torch.inference_mode(); then
     CamInferencer.infer_batch on two images of different sizes (the bucketed,
     masked path). The PCM launch count and torch.profiler both have to show
     the kernel on this path;
  6. a yardstick for the TPU kernel not ported yet: the library call at its
     shape, with its bound.
The second-to-last lines are the kernel table as JSON and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.
Weights are random, from a seed; nothing is downloaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from wseg_tpu_torch.infer.cam import CamInferencer, make_fused_msf_fn
from wseg_tpu_torch.kernels import _build, pcm_cuda
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.ops.pcm import pcm_flat

SEED = 0
RTOL, ATOL = 2e-3, 2e-4          # the kernel's tolerance (tests/test_pcm_pallas.py)
SLICE_ATOL = 1e-3                # fused CAM, card (kernel) vs CPU (plain)
H0, W0, BATCH = 384, 512, 8      # bench.py --mode cam working size
SCALES = (0.5, 1.0, 1.5, 2.0)
PCM_KERNEL_NAME = "pcm_fused_kernel"

# NVIDIA H100 data sheet, dense: f32 on the CUDA cores (FLOP/s), HBM (B/s)
PEAKS = {"PCIe": (51e12, 2.0e12), "SXM": (67e12, 3.35e12)}


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
    """The kernel against the plain version on the same inputs; bf16 features
    enter the plain version widened to f32 (exact), as the kernel reads them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hw2 = (H0 // 8 * 2) * (W0 // 8 * 2)  # stride-8 map of the scale-2 view
    cases = [
        ("scale2_pair_f32", dict(n=2, hw=hw2, cf=192)),
        ("tail_hw700", dict(n=1, hw=700, cf=64)),
        ("tail_hw700_cf192", dict(n=2, hw=700, cf=192)),
        ("masked_scale1", dict(n=4, hw=hw2 // 4, cf=192, masked=True)),
        ("main_path_bf16", dict(n=2 * BATCH, hw=hw2, cf=192, f_dtype=torch.bfloat16)),
    ]
    _, peak_flops, peak_bw = peaks(card_name)
    row = None
    for name, kw in cases:
        cam, f, mask = pcm_inputs(gen, **kw)
        got = pcm_cuda.pcm_fused(cam, f, mask=mask)
        torch.cuda.synchronize()
        want = pcm_flat(cam, f.float(), mask=mask)
        err = (got - want).abs()
        tol = ATOL + RTOL * want.abs()
        ok = bool((err <= tol).all())
        msg = (f"[kernel] {name} {tuple(f.shape)} {str(f.dtype)[6:]} "
               f"max_abs_err={err.max().item():.3e} max_rel_err={(err / want.abs().clamp_min(1e-12)).max().item():.3e} "
               f"within rtol={RTOL} atol={ATOL}: {ok}")
        if name in ("scale2_pair_f32", "main_path_bf16"):
            ms = cuda_ms(lambda: pcm_cuda.pcm_fused(cam, f, mask=mask))
            plain_ms = cuda_ms(lambda: pcm_flat(cam, f.float(), mask=mask), iters=3, warmup=1)
            flops, nbytes = pcm_flops(kw["n"], kw["hw"], kw["cf"]), pcm_bytes(cam, f, mask)
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            msg += (f" | {card_name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {max(t_ops, t_bytes):.3f} ms ({flops / 1e9:.1f} GFLOP f32, "
                    f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.1f} TFLOP/s")
            if name == "main_path_bf16":
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
    pcm_cuda.launches = 0
    got = make_fused_msf_fn(model_gpu, (h0, w0))(tuple(v.cuda() for v in views), label.cuda())
    torch.cuda.synchronize()
    launches = pcm_cuda.launches
    err = (got.cpu() - want).abs().max().item()
    print(f"[slice-parity] fused CAM {tuple(got.shape)} card (kernel, f32, TF32 off) vs CPU "
          f"(plain): max_abs_err={err:.3e} (atol {SLICE_ATOL}), PCM launches {launches}", flush=True)
    if launches != len(SCALES):
        raise SystemExit(f"chip_smoke: expected {len(SCALES)} PCM launches, saw {launches}")
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
    pcm_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn(views, label)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = pcm_cuda.launches
    check_fused(out, (BATCH, 20, H0, W0))
    if launches < 1:
        raise SystemExit("chip_smoke: the main path launched no PCM kernel")
    peak_mem = torch.cuda.max_memory_allocated()

    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(views, label)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / iters

    totals = profile_kernels(lambda: fn(views, label))
    pcm_ms = sum(v for k, v in totals.items() if PCM_KERNEL_NAME in k)
    if pcm_ms <= 0:
        raise SystemExit(f"chip_smoke: torch.profiler saw no {PCM_KERNEL_NAME} on the main path")
    busy = sum(totals.values())
    print(f"{card} | slice 384x512 4 scales x flip, batch {BATCH}, bf16 trunk, f32 fusion: "
          f"{BATCH / steady:.2f} images/s (mean of {iters} batches, {steady * 1e3:.1f} ms/batch; "
          f"first timed batch {dt * 1e3:.1f} ms)", flush=True)
    print(f"{card} | peak device memory {peak_mem / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    print(f"{card} | PCM launches per image {launches / BATCH:.3f} "
          f"({launches} per batch of {BATCH})")
    print(f"{card} | profiled batch: device busy {busy:.1f} ms; PCM kernel {pcm_ms:.1f} ms "
          f"({100 * pcm_ms / busy:.1f}% of device time)")
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
    pcm_cuda.launches = 0
    cams = inferencer.infer_batch(items)
    torch.cuda.synchronize()
    masked_launches = pcm_cuda.launches
    for cam, (_, _, hw) in zip(cams, items):
        check_fused(torch.from_numpy(cam), (20, *hw))
    totals_b = profile_kernels(lambda: inferencer.infer_batch(items))
    if masked_launches < 1 or not any(PCM_KERNEL_NAME in k for k in totals_b):
        raise SystemExit("chip_smoke: the bucketed (masked) path did not run the PCM kernel")
    print(f"{card} | infer_batch bucketed+masked, 2 images (333x500, 375x441): "
          f"PCM launches {masked_launches}", flush=True)
    return launches


def phase_pending_kernels(card: str):
    """Yardstick for the TPU kernel still to port (K2,
    wseg_tpu/kernels/conv_pallas.py:conv3x3_dilated): one F.conv2d call at its
    largest main-path shape, b7's dilated 3x3 (d=4, 1024 -> 2048) on the
    stride-8 maps of the scale-2 views, bf16, channels_last. The port's trunk
    calls cuDNN through F.conv2d today; this times that call beside its bound."""
    import torch.nn.functional as F

    n, h, w, ci, co, d = 2 * BATCH, H0 // 4, W0 // 4, 1024, 2048, 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn(n, ci, h, w, generator=gen, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    k = (torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    k = k.contiguous(memory_format=torch.channels_last)
    ms = cuda_ms(lambda: F.conv2d(x, k, padding=d, dilation=d))
    flops = 2.0 * n * h * w * 9 * ci * co
    nbytes = 2.0 * (x.numel() + k.numel() + n * co * h * w)
    part, _, peak_bw = peaks(torch.cuda.get_device_name(0))
    bf16_peak = {"PCIe": 756e12, "SXM": 989e12}[part]
    bound = max(flops / bf16_peak, nbytes / peak_bw) * 1e3
    print(f"{card} | K2 (not ported) library F.conv2d 3x3 d={d} {ci}->{co} on "
          f"({n}, {ci}, {h}, {w}) bf16: {ms:.3f} ms, bound {bound:.3f} ms "
          f"({flops / 1e12:.2f} TFLOP at the bf16 tensor-core peak), "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    phase_build()
    row = phase_kernel_vs_plain(name)
    phase_slice_parity()
    row["launches"] = phase_working_size(card)
    phase_pending_kernels(card)
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
