"""The dilated 3x3 conv (K2) as a hand-written CUDA kernel (csrc/conv3x3.cu).

Replaces wseg_tpu/kernels/conv_pallas.py:conv3x3_dilated: an implicit GEMM
(M = output pixels, N = CO, K = 9 taps x CI) that gathers each tap's halo on
load, so no padded or shifted copy of x is written. See the note at the top
of csrc/conv3x3.cu for its design and its bound.

A tensor on the CPU goes through the plain version
(ops/conv.py:conv3x3_dilated_plain); a CUDA tensor launches the kernel or
raises. `launches` counts kernel launches, so a run can show that its path
went through the kernel. Like the JAX package's models, the port's trunk does
not call this kernel: its entry point is the probe, cli/conv_probe.py.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wseg_tpu_torch.kernels import _build
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain

launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built on first use, with its argument types."""
    fn = _build.load("conv3x3").conv3x3_dilated_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3_dilated(x: torch.Tensor, k: torch.Tensor, dilation: int = 4,
                    tile_co: int = 256) -> torch.Tensor:
    """x (B, H, W, CI), k (3, 3, CI, CO). Stride-1 SAME conv with `dilation`
    (padding == dilation). Returns (B, H, W, CO) in x.dtype with float32
    accumulation. Any H, W, CI and CO (no divisibility needed); `tile_co`
    output channels go to one block. float32 or bfloat16 on the card."""
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
    if x.dtype not in (torch.float32, torch.bfloat16) or k.dtype != x.dtype:
        raise TypeError(f"conv3x3_dilated: x and k must both be float32 or bfloat16, "
                        f"got {x.dtype} and {k.dtype}")

    b, h, w, ci = x.shape
    co = k.shape[3]
    if b * h * w > 2**31 - 1 - 128 or -(-co // int(tile_co)) > 65535:
        raise ValueError(f"conv3x3_dilated: {b * h * w} pixels or {co}/{tile_co} channel "
                         "tiles exceed the kernel's grid")
    x = x.contiguous()
    k = k.contiguous()
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    vec = (x.dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0
           and x.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0)

    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), k.data_ptr(), out.data_ptr(),
                     int(x.dtype == torch.bfloat16), int(vec), b, h, w, ci, co,
                     int(dilation), int(tile_co), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_dilated: CUDA launch failed with cudaError_t {err}")
    launches += 1
    return out
