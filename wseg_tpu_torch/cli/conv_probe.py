"""Probe of K2, the hand-written dilated 3x3 conv (kernels/conv_cuda.py),
against the library conv at the trunk's dominant shape (b6/b7: 3x3,
dilation 4, 1024 -> 2048 on 16 stride-8 maps of 48x64, bf16). Counterpart
of scripts/conv_probe.py.

    python -m wseg_tpu_torch.cli.conv_probe [--batch 16 --height 48 --width 64
        --ci 1024 --co 2048 --dilation 4 --dtype bfloat16] [--device cpu]

Times `F.conv2d` (channels_last; the yardstick only, never K2 itself) and
K2 at each tile_co in TILE_CO, ITERS calls each after a warm-up, and prints
ms, TFLOP/s and K2's max abs error against the yardstick. At the default
bf16 shape K2 is the wgmma kernel, whose N width follows tile_co (128 ->
wgmma N = 128; 256 and 512 -> N = 256). Runs on the GPU
unless `--device cpu`, where K2's wrapper takes its plain version and the
times are the CPU's. In float32 TF32 is turned off, so both sides compute in
full float32.
"""

from __future__ import annotations

import argparse
import math
import time

TILE_CO = (128, 256, 512)
ITERS = 20


def _time_ms(fn, device) -> float:
    import torch

    fn()  # warm-up: builds and loads the kernel on first use
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return (time.perf_counter() - t0) / ITERS * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / ITERS


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", default=16, type=int)
    parser.add_argument("--height", default=48, type=int)
    parser.add_argument("--width", default=64, type=int)
    parser.add_argument("--ci", default=1024, type=int)
    parser.add_argument("--co", default=2048, type=int)
    parser.add_argument("--dilation", default=4, type=int)
    parser.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from wseg_tpu_torch.kernels.conv_cuda import conv3x3_dilated, conv_variant
    from wseg_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    if device.type == "cuda" and dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    b, h, w, ci, co, d = args.batch, args.height, args.width, args.ci, args.co, args.dilation
    flops = 2.0 * 9 * b * h * w * ci * co
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"conv_probe on {where}: x ({b}, {h}, {w}, {ci}) k (3, 3, {ci}, {co}) "
          f"d={d} {args.dtype}, {flops / 1e12:.3f} TFLOP", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((b, h, w, ci), generator=gen, device=device).to(dtype)
    # unit-variance outputs: the error readings are then relative to ~1
    k = (torch.randn((3, 3, ci, co), generator=gen, device=device) / math.sqrt(9 * ci)).to(dtype)

    x_nchw = x.permute(0, 3, 1, 2)  # NHWC memory = channels_last NCHW
    k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        return F.conv2d(x_nchw, k_oihw, padding=d, dilation=d)

    ref = library().permute(0, 2, 3, 1).float()
    ms = _time_ms(library, device)
    results = [{"name": "library F.conv2d", "ms": ms, "tflops": flops / ms / 1e9}]
    print(f"library F.conv2d: {ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)

    # the kernel a card runs for these inputs (the CPU runs the plain version)
    variant = conv_variant(dtype, ci, co, x.data_ptr() % 16 == 0) if device.type == "cuda" \
        else "plain"
    for tco in TILE_CO:
        out = conv3x3_dilated(x, k, dilation=d, tile_co=tco)
        err = float((out.float() - ref).abs().max())
        ms = _time_ms(lambda: conv3x3_dilated(x, k, dilation=d, tile_co=tco), device)
        results.append({"name": "k2", "variant": variant, "tile_co": tco, "ms": ms,
                        "tflops": flops / ms / 1e9, "max_abs_err": err})
        print(f"k2 ({variant}) tile_co={tco}: {ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s  "
              f"max_abs_err={err:.3g}", flush=True)
    return results


if __name__ == "__main__":
    main()
