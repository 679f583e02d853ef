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

Two entry points: `conv3x3_dilated`, the JAX kernel's (B, H, W, CI) x (3, 3,
CI, CO) interface (cli/conv_probe.py), and `conv3x3_dilated_nchw`, a torch
conv layer's channels_last (B, CI, H, W) x (CO, CI, 3, 3) in f32, a view of
the first, which the trunk's dilation-4 convs call in training
(models/layers.py:DilatedConv2d).
A tensor on the CPU goes through the plain version
(ops/conv.py:conv3x3_dilated_plain); a CUDA tensor launches a kernel or
raises. `launches` counts kernel launches and `variant_launches` counts them
per variant, so a run can show that its path went through the kernel it
expected.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wseg_tpu_torch.kernels import _build
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain

TILE_WIDTHS = (128, 64, 32, 16)  # pixel-tile widths of the wgmma kernel; th = 128 // tw
F32_TILE_CO = 128  # output channels a block of the f32 kernel takes
VARIANTS = ("wgmma", "mma_sync", "fma")

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
    for fn in (bf16, f32, wgmma):
        fn.restype = ctypes.c_int
    return bf16, f32, wgmma


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
    `variant` names the kernel instead of `conv_variant`'s choice (to time
    one against another); a variant that cannot take the inputs raises."""
    global launches
    if x.dim() != 4 or k.dim() != 4 or tuple(k.shape[:2]) != (3, 3) or k.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_dilated: x {tuple(x.shape)} and k {tuple(k.shape)} "
                         "must be (B, H, W, CI) and (3, 3, CI, CO)")
    if int(dilation) < 1 or int(tile_co) < 1:
        raise ValueError(f"conv3x3_dilated: dilation {dilation} and tile_co {tile_co} must be >= 1")
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
        bf16, _, wgmma = _launchers()
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


def conv3x3_dilated_nchw(x: torch.Tensor, w: torch.Tensor, dilation: int = 4) -> torch.Tensor:
    """F.conv2d(x, w, padding=dilation, dilation=dilation) of float32 x (B,
    CI, H, W) and w (CO, CI, 3, 3) on the f32 kernel: exact f32 products and
    sums (no TF32). `conv3x3_dilated` on the NHWC view of x, with F32_TILE_CO
    output channels a block; channels_last x is read in place (any other x is
    copied to NHWC first), and the output is channels_last. The kernel's
    rows, (3, 3, CI, CO), are written once per call."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) or w.shape[1] != x.shape[1]:
        raise ValueError(f"conv3x3_dilated_nchw: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (B, CI, H, W) and (CO, CI, 3, 3)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv3x3_dilated_nchw: x and w must be float32, got {x.dtype} and "
                        f"{w.dtype}")
    out = conv3x3_dilated(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0), dilation,
                          tile_co=F32_TILE_CO, variant="fma")
    return out.permute(0, 3, 1, 2)
