"""The dilated 3x3 conv (K2) as hand-written CUDA kernels (csrc/conv3x3.cu).

Replaces wseg_tpu/kernels/conv_pallas.py:conv3x3_dilated: an implicit GEMM
(M = output pixels, N = CO, K = 9 taps x CI) that gathers each tap's halo on
load, so no padded or shifted copy of x is written. See the note at the top
of csrc/conv3x3.cu for the designs and their bound. Three variants, chosen by
`conv_variant` from the dtype, the channel counts and the alignment before
the launch:

- "wgmma": bf16, CI and CO multiples of 8, x 16-byte aligned (what TMA
  needs): `conv3x3_wgmma_kernel`, TMA-fed wgmma. The wrapper writes the
  kernel K-major, (CO, 3, 3, CI), once per call, and picks the pixel tile
  with `conv_tile_shape`.
- "mma_sync": every other bf16 shape: `conv3x3_bf16_kernel`, mma.sync.
- "fma": f32, exact (no TF32): `conv3x3_f32_kernel`.

Entry points: `conv3x3_dilated`, the JAX kernel's (B, H, W, CI) x (3, 3,
CI, CO) interface (cli/conv_probe.py), and `conv3x3_dilated_nchw`, a torch
conv layer's channels_last (B, CI, H, W) x (CO, CI, 3, 3) in f32, a view of
the first, which the trunk's dilation-4 convs call in training
(models/layers.py:DilatedConv2d). Their gradients in f32, for the layer's
backward: `conv3x3_dilated_dgrad`, the input's, on the "fma" kernel at
dilation -d (the kernel rotated 180 degrees); `conv3x3_dilated_wgrad`, the
weight's, on `conv3x3_wgrad_f32_kernel` (variant "wgrad").
A tensor on the CPU goes through the plain version
(ops/conv.py:conv3x3_dilated_plain, conv3x3_dilated_wgrad_plain); a CUDA
tensor launches a kernel or raises. `launches` counts the wrappers' kernel
launches (a split weight gradient's second pass counts with its first) and
`variant_launches` counts them per variant, so a run can show that its path
went through the kernel it expected.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from wseg_tpu_torch.kernels import _build
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain, conv3x3_dilated_wgrad_plain

TILE_WIDTHS = (128, 64, 32, 16)  # pixel-tile widths of the wgmma kernel; th = 128 // tw
F32_TILE_CO = 128  # output channels a block of the f32 kernel takes
WGRAD_TILE = 128  # (tap, CI) rows and CO columns of a wgrad block tile
WGRAD_BLOCKS_PER_SM = 2  # wgrad blocks resident on an SM (64 KB of ring, 128 registers)
# chunks of 16 pixels a range of a split weight gradient keeps at least: at
# fewer, each block's fixed cost and the partials' pass outweigh the fuller
# waves (b6 at the 128 view: split 2 of 128 chunks 0.624 ms, 4 0.725; PERF.md)
WGRAD_MIN_CHUNKS = 64
VARIANTS = ("wgmma", "mma_sync", "fma", "wgrad")

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for name in VARIANTS:
        variant_launches[name] = 0


def conv_variant(dtype: torch.dtype, ci: int, co: int, aligned: bool = True) -> str:
    """The kernel a CUDA call runs: `aligned` says whether x's data pointer
    is 16-byte aligned (the K-major kernel copy always is)."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_dilated: x and k must both be float32 or bfloat16, got {dtype}")
    if ci % 8 == 0 and co % 8 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def conv_tile_shape(h: int, w: int) -> tuple[int, int]:
    """(th, tw) of the wgmma kernel's 128-pixel tile: the width in
    TILE_WIDTHS whose tiles cover the H x W image with the fewest padded
    pixels, the widest of equals."""
    def covered(tw: int) -> int:
        th = 128 // tw
        return -(-w // tw) * tw * (-(-h // th) * th)

    tw = min(TILE_WIDTHS, key=covered)  # min keeps the first (widest) of equals
    return 128 // tw, tw


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points, built on first use, with their argument types."""
    lib = _build.load("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    bf16 = lib.conv3x3_bf16_launch  # mma_sync
    bf16.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    f32 = lib.conv3x3_f32_launch  # fma
    f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    wgmma = lib.conv3x3_wgmma_launch
    wgmma.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    wgrad = lib.conv3x3_wgrad_f32_launch
    wgrad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    for fn in (bf16, f32, wgmma, wgrad):
        fn.restype = ctypes.c_int
    return bf16, f32, wgmma, wgrad


def _launch_f32(x: torch.Tensor, k: torch.Tensor, out: torch.Tensor, dilation: int,
                tile_co: int) -> int:
    """The f32 kernel on contiguous x, k and out; returns the C entry point's
    cudaError_t."""
    b, h, w, ci = x.shape
    co = k.shape[3]
    vec_a = ci % 4 == 0 and x.data_ptr() % 16 == 0
    vec_b = co % 4 == 0 and tile_co % 4 == 0 and k.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _launchers()[1](x.data_ptr(), k.data_ptr(), out.data_ptr(), int(vec_a),
                               int(vec_b), b, h, w, ci, co, dilation, tile_co, stream)


def conv3x3_dilated(x: torch.Tensor, k: torch.Tensor, dilation: int = 4,
                    tile_co: int = 256, variant: str | None = None) -> torch.Tensor:
    """x (B, H, W, CI), k (3, 3, CI, CO). Stride-1 SAME conv with `dilation`
    (padding == dilation). Returns (B, H, W, CO) in x.dtype with float32
    accumulation. Any H, W, CI and CO (no divisibility needed); `tile_co`
    output channels go to one block. float32 or bfloat16 on the card.
    A negative `dilation` on float32 is the conv with k rotated 180 degrees
    at |dilation| (tap (dy, dx) reads x at ((dy-1)d, (dx-1)d)).
    `variant` names the kernel instead of `conv_variant`'s choice (to time
    one against another); a variant that cannot take the inputs raises."""
    global launches
    if x.dim() != 4 or k.dim() != 4 or tuple(k.shape[:2]) != (3, 3) or k.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_dilated: x {tuple(x.shape)} and k {tuple(k.shape)} "
                         "must be (B, H, W, CI) and (3, 3, CI, CO)")
    if int(dilation) == 0 or (int(dilation) < 0 and x.dtype == torch.bfloat16) \
            or int(tile_co) < 1:
        raise ValueError(f"conv3x3_dilated: dilation {dilation} must be nonzero (negative not "
                         f"in bfloat16) and tile_co {tile_co} >= 1")
    if min(x.shape) < 1 or k.shape[3] < 1:
        raise ValueError(f"conv3x3_dilated: empty operand x {tuple(x.shape)} k {tuple(k.shape)}")
    if x.device != k.device:
        raise ValueError("conv3x3_dilated: x and k must be on one device")
    if x.device.type == "cpu":
        return conv3x3_dilated_plain(x, k, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_dilated: unsupported device {x.device}")
    if k.dtype != x.dtype:
        raise TypeError(f"conv3x3_dilated: x and k must both be float32 or bfloat16, "
                        f"got {x.dtype} and {k.dtype}")

    b, h, w, ci = x.shape
    co = k.shape[3]
    x = x.contiguous()
    chosen = conv_variant(x.dtype, ci, co, x.data_ptr() % 16 == 0)
    if variant is not None and variant != chosen and not (variant == "mma_sync"
                                                          and x.dtype == torch.bfloat16):
        raise ValueError(f"conv3x3_dilated: variant {variant!r} cannot take {x.dtype} "
                         f"x {tuple(x.shape)} -> {co}")
    variant = variant or chosen
    if b * h * w > 2**31 - 1 - 128 or -(-co // int(tile_co)) > 65535:
        raise ValueError(f"conv3x3_dilated: {b * h * w} pixels or {co}/{tile_co} channel "
                         "tiles exceed the kernel's grid")
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)

    if variant == "fma":
        err = _launch_f32(x, k.contiguous(), out, int(dilation), int(tile_co))
    else:
        bf16, _, wgmma, _ = _launchers()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if variant == "wgmma":
                k_kmajor = k.permute(3, 0, 1, 2).contiguous()  # (CO, 3, 3, CI)
                _, tw = conv_tile_shape(h, w)
                err = wgmma(x.data_ptr(), k_kmajor.data_ptr(), out.data_ptr(), b, h, w, ci, co,
                            int(dilation), int(tile_co), tw, stream)
            else:
                k = k.contiguous()
                vec = (ci % 8 == 0 and co % 8 == 0 and x.data_ptr() % 16 == 0
                       and k.data_ptr() % 16 == 0)
                err = bf16(x.data_ptr(), k.data_ptr(), out.data_ptr(), int(vec), b, h, w, ci,
                           co, int(dilation), int(tile_co), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_dilated: CUDA launch ({variant}) failed with error {err}")
    launches += 1
    variant_launches[variant] += 1
    return out


def _check_f32(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Both float32, or both float64 on the CPU (the plain twins, for gradcheck)."""
    if a.dtype != b.dtype or not (a.dtype == torch.float32 or (
            a.dtype == torch.float64 and a.device.type == b.device.type == "cpu")):
        raise TypeError(f"{what}: the operands must be float32 (float64 on the CPU), got "
                        f"{a.dtype} and {b.dtype}")


def _nchw_f32_checks(what: str, x: torch.Tensor, w: torch.Tensor, ci_dim: int) -> None:
    """x (B, C, H, W) and w (CO, CI, 3, 3) with C = w.shape[ci_dim], float32."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) \
            or w.shape[ci_dim] != x.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit "
                         "(B, C, H, W) and (CO, CI, 3, 3)")
    _check_f32(what, x, w)


def conv3x3_dilated_nchw(x: torch.Tensor, w: torch.Tensor, dilation: int = 4) -> torch.Tensor:
    """F.conv2d(x, w, padding=dilation, dilation=dilation) of float32 x (B,
    CI, H, W) and w (CO, CI, 3, 3) on the f32 kernel: exact f32 products and
    sums (no TF32); float64 too on the CPU. `conv3x3_dilated` on the NHWC
    view of x, with F32_TILE_CO output channels a block; channels_last x is
    read in place (any other x is copied to NHWC first), and the output is
    channels_last. The kernel's rows, (3, 3, CI, CO), are written once per
    call."""
    _nchw_f32_checks("conv3x3_dilated_nchw", x, w, 1)
    out = conv3x3_dilated(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0), dilation,
                          tile_co=F32_TILE_CO, variant="fma")
    return out.permute(0, 3, 1, 2)


def conv3x3_dilated_dgrad(grad: torch.Tensor, w: torch.Tensor, dilation: int = 4) -> torch.Tensor:
    """The input gradient of conv3x3_dilated_nchw(x, w, dilation) from the
    output's gradient `grad` (B, CO, H, W): (B, CI, H, W), channels_last. It
    is the same conv of `grad` with w rotated 180 degrees and its channels
    swapped; rotating the taps negates their offsets, so it runs on the f32
    kernel at dilation -d from w's (3, 3, CO, CI) rows (one copy of w, no
    flipped one). channels_last grad is read in place, any other is copied to
    NHWC first."""
    _nchw_f32_checks("conv3x3_dilated_dgrad", grad, w, 0)
    if int(dilation) < 1:
        raise ValueError(f"conv3x3_dilated_dgrad: dilation {dilation} must be >= 1")
    out = conv3x3_dilated(grad.permute(0, 2, 3, 1), w.permute(2, 3, 0, 1), -int(dilation),
                          tile_co=F32_TILE_CO, variant="fma")
    return out.permute(0, 3, 1, 2)


def wgrad_split(ci: int, co: int, pixels: int, sms: int) -> int:
    """Ranges the weight gradient's pixel reduction is cut into: 1 when its
    9 ceil(CI/128) x ceil(CO/128) block tiles fill four waves of the card's
    WGRAD_BLOCKS_PER_SM x `sms` block slots; else, of the splits up to 4 that
    leave every range WGRAD_MIN_CHUNKS chunks of 16 pixels, the one whose
    last wave is fullest (the fewest of equals). On the card (PERF.md): b7
    (1024 -> 2048), 1152 tiles on 264 slots, 1; b6 (512 -> 1024), 288 tiles,
    4 at crop 448 (25,088 pixels), 2 at the 128 view (2,048), 1 at 512."""
    tiles = 9 * math.ceil(ci / WGRAD_TILE) * math.ceil(co / WGRAD_TILE)
    slots = WGRAD_BLOCKS_PER_SM * sms
    most = min(4, math.ceil(pixels / 16) // WGRAD_MIN_CHUNKS)
    if tiles >= 4 * slots or most <= 1:
        return 1

    def fill(s: int) -> float:
        return tiles * s / (math.ceil(tiles * s / slots) * slots)

    return max(range(1, most + 1), key=lambda s: (fill(s), -s))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_dilated_wgrad(x: torch.Tensor, grad: torch.Tensor, dilation: int = 4,
                          split: int | None = None) -> torch.Tensor:
    """The weight gradient of conv3x3_dilated_nchw(x, w, dilation): (CO, CI,
    3, 3) from float32 x (B, CI, H, W) and the output's gradient `grad` (B,
    CO, H, W), exact f32 products and sums. On the card
    `conv3x3_wgrad_f32_kernel` reads both as NHWC (channels_last ones in
    place, any other is copied first) and writes the result in its own
    layout; its pixel reduction is cut into `split` ranges (`wgrad_split`'s
    choice by default), whose partials, in a scratch of split - 1 results,
    a second pass adds in order, so a call repeats bit for bit."""
    global launches
    what = "conv3x3_dilated_wgrad"
    if x.dim() != 4 or grad.dim() != 4 or x.shape[0] != grad.shape[0] \
            or x.shape[2:] != grad.shape[2:]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and grad {tuple(grad.shape)} must be "
                         "(B, CI, H, W) and (B, CO, H, W)")
    _check_f32(what, x, grad)
    if int(dilation) < 1 or (split is not None and int(split) < 1) or min(x.shape) < 1 \
            or grad.shape[1] < 1:
        raise ValueError(f"{what}: dilation {dilation} and split {split} must be >= 1, the "
                         "operands non-empty")
    if x.device != grad.device:
        raise ValueError(f"{what}: x and grad must be on one device")
    xh, gh = x.permute(0, 2, 3, 1), grad.permute(0, 2, 3, 1)
    if x.device.type == "cpu":
        return conv3x3_dilated_wgrad_plain(xh, gh, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    b, h, w, ci = xh.shape
    co = gh.shape[3]
    xh, gh = xh.contiguous(), gh.contiguous()
    split = int(split or wgrad_split(ci, co, b * h * w, _sms(x.device.index or 0)))
    if b * h * w > 2**31 - 1 - 64 or -(-co // WGRAD_TILE) > 65535 or split > 65535:
        raise ValueError(f"{what}: {b * h * w} pixels, {co} output channels or split {split} "
                         "exceed the kernel's grid")
    dw = torch.empty((co, ci, 3, 3), dtype=x.dtype, device=x.device)
    parts = torch.empty((split - 1, co, ci, 3, 3), dtype=x.dtype, device=x.device) \
        if split > 1 else None
    vec_a = ci % 4 == 0 and xh.data_ptr() % 16 == 0
    vec_b = co % 4 == 0 and gh.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[3](xh.data_ptr(), gh.data_ptr(), dw.data_ptr(),
                              parts.data_ptr() if parts is not None else None, int(vec_a),
                              int(vec_b), b, h, w, ci, co, int(dilation), split, stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch (wgrad, split {split}) failed with error {err}")
    launches += 1
    variant_launches["wgrad"] += 1
    return dw
