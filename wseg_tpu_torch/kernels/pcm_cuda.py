"""PCM as a hand-written CUDA kernel (csrc/pcm.cu), forward only.

Replaces wseg_tpu/kernels/pcm_pallas.py:pcm_fused. The kernel never writes
the hw x hw affinity to device memory; see the note at the top of
csrc/pcm.cu for its design and its bound.

A tensor on the CPU goes through the plain version (ops/pcm.py:pcm_flat); a
CUDA tensor launches the kernel or raises. `launches` counts kernel launches,
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wseg_tpu_torch.kernels import _build
from wseg_tpu_torch.ops.pcm import pcm_flat
from wseg_tpu_torch.ops.resize import resize_bilinear

MAX_CHANNELS = 23  # cam channels the kernel holds (CE - 1 in csrc/pcm.cu)

launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built on first use, with its argument types."""
    fn = _build.load("pcm").pcm_fused_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, p, p, p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def pcm_fused(cam: torch.Tensor, f: torch.Tensor, eps: float = 1e-5,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """cam (N, HW, C) at f's resolution; f (N, HW, Cf) raw f9 features, f32
    or bf16 (normalized inside); mask optional (N, HW) or (N, HW, 1) valid-
    pixel mask, applied after the normalization exactly as ops/pcm.py:pcm.
    Returns (N, HW, C) in cam's dtype; accumulates in f32."""
    global launches
    if cam.dim() != 3 or f.dim() != 3 or cam.shape[:2] != f.shape[:2]:
        raise ValueError(f"pcm_fused: cam {tuple(cam.shape)} and f {tuple(f.shape)} "
                         "must be (N, HW, C) and (N, HW, Cf)")
    if cam.device != f.device or (mask is not None and mask.device != f.device):
        raise ValueError("pcm_fused: cam, f and mask must be on one device")
    if cam.device.type == "cpu":
        return pcm_flat(cam, f, eps, mask)
    if cam.device.type != "cuda":
        raise ValueError(f"pcm_fused: unsupported device {cam.device}")

    n, hw, c = cam.shape
    cf = f.shape[2]
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pcm_fused: f must be float32 or bfloat16, got {f.dtype}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"pcm_fused: C={c} outside 1..{MAX_CHANNELS}")
    if n > 65535:
        raise ValueError(f"pcm_fused: batch {n} > 65535")
    cam32 = cam.to(torch.float32).contiguous()
    f = f.contiguous()
    mask32 = None
    if mask is not None:
        if mask.numel() != n * hw:
            raise ValueError(f"pcm_fused: mask {tuple(mask.shape)} is not (N, HW)")
        mask32 = mask.to(torch.float32).reshape(n, hw).contiguous()
    out = torch.empty((n, hw, c), dtype=torch.float32, device=cam.device)
    scale = torch.empty((n, hw), dtype=torch.float32, device=cam.device)

    launch = _launcher()
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream(cam.device).cuda_stream
        err = launch(
            cam32.data_ptr(), f.data_ptr(), int(f.dtype == torch.bfloat16),
            None if mask32 is None else mask32.data_ptr(), scale.data_ptr(),
            out.data_ptr(), n, hw, c, cf, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"pcm_fused: CUDA launch failed with cudaError_t {err}")
    launches += 1
    return out.to(cam.dtype)


def pcm_fused_nchw(cam: torch.Tensor, f: torch.Tensor, eps: float = 1e-5,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """NCHW form of ops/pcm.py:pcm: cam (N, C, Hc, Wc) is first resized to
    f's (N, Cf, H, W) spatial dims (align_corners=True); mask (N, 1, H, W).
    Returns (N, C, H, W)."""
    n, cf, h, w = f.shape
    cam = resize_bilinear(cam, (h, w), align_corners=True)
    c = cam.shape[1]
    out = pcm_fused(
        cam.permute(0, 2, 3, 1).reshape(n, h * w, c),
        f.permute(0, 2, 3, 1).reshape(n, h * w, cf),
        eps, None if mask is None else mask.reshape(n, h * w),
    )
    return out.reshape(n, h, w, c).permute(0, 3, 1, 2)
