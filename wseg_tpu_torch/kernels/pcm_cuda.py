"""PCM as hand-written CUDA kernels (csrc/pcm.cu), forward only.

Replaces wseg_tpu/kernels/pcm_pallas.py:pcm_fused. No kernel writes the
hw x hw affinity to device memory; see the note at the top of csrc/pcm.cu for
the designs and their bounds. Two variants, chosen by `pcm_variant` from f's
dtype and width before the launch:

- "mma": bf16 features (Cf <= 256), on the tensor cores (`pcm_mma_kernel`).
  fn is rounded once to bf16, as the TPU kernel rounds it; P = relu(S) and
  cam enter the second product as bf16 hi + lo pairs, so that product is
  f32-accurate to about 2^-16. Its plain twin is ops/pcm.py:pcm_flat_bf16.
- "fma": f32 features (and bf16 ones wider than 256 channels), f32 FMA on
  the CUDA cores (`pcm_fused_kernel`); its plain twin is ops/pcm.py:pcm_flat.

A tensor on the CPU goes through the plain twin; a CUDA tensor launches a
kernel or raises. `launches` counts kernel launches and `variant_launches`
counts them per variant, so a run can show that its main path went through
the kernel it expected.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wseg_tpu_torch.kernels import _build
from wseg_tpu_torch.ops.pcm import pcm_flat, pcm_flat_bf16
from wseg_tpu_torch.ops.resize import resize_bilinear

MAX_CHANNELS = 23  # cam channels the kernels hold (CE - 1 and VC - 1 in csrc/pcm.cu)
MMA_MAX_CF = 256   # feature channels the tensor-core variant keeps in registers
VARIANTS = ("mma", "fma")

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for name in VARIANTS:
        variant_launches[name] = 0


def pcm_variant(f_dtype: torch.dtype, cf: int) -> str:
    """The kernel a CUDA call with features of `f_dtype` and width `cf` runs."""
    if f_dtype == torch.bfloat16 and cf <= MMA_MAX_CF:
        return "mma"
    if f_dtype in (torch.float32, torch.bfloat16):
        return "fma"
    raise TypeError(f"pcm_fused: f must be float32 or bfloat16, got {f_dtype}")


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points, built on first use, with their argument types."""
    lib = _build.load("pcm")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fma = lib.pcm_fused_launch
    fma.argtypes = [p, p, i, p, p, p, i, i, i, i, fl, p]
    mma = lib.pcm_mma_launch
    mma.argtypes = [p, p, p, p, p, p, i, i, i, i, i, fl, p]
    for fn in (fma, mma):
        fn.restype = ctypes.c_int
    return {"fma": fma, "mma": mma}


def pcm_fused(cam: torch.Tensor, f: torch.Tensor, eps: float = 1e-5,
              mask: torch.Tensor | None = None, variant: str | None = None) -> torch.Tensor:
    """cam (N, HW, C) at f's resolution; f (N, HW, Cf) raw f9 features, f32
    or bf16 (normalized inside); mask optional (N, HW) or (N, HW, 1) valid-
    pixel mask, applied after the normalization exactly as ops/pcm.py:pcm.
    Returns (N, HW, C) in cam's dtype; accumulates in f32. `variant` names
    the kernel instead of `pcm_variant`'s choice (to time one against the
    other); a variant that cannot take the inputs raises."""
    global launches
    if cam.dim() != 3 or f.dim() != 3 or cam.shape[:2] != f.shape[:2]:
        raise ValueError(f"pcm_fused: cam {tuple(cam.shape)} and f {tuple(f.shape)} "
                         "must be (N, HW, C) and (N, HW, Cf)")
    if cam.device != f.device or (mask is not None and mask.device != f.device):
        raise ValueError("pcm_fused: cam, f and mask must be on one device")
    if cam.device.type == "cpu":
        plain = pcm_flat_bf16 if f.dtype == torch.bfloat16 else pcm_flat
        return plain(cam, f, eps, mask)
    if cam.device.type != "cuda":
        raise ValueError(f"pcm_fused: unsupported device {cam.device}")

    n, hw, c = cam.shape
    cf = f.shape[2]
    chosen = pcm_variant(f.dtype, cf)
    if variant is not None and variant != chosen and not (variant == "fma"
                                                          and f.dtype == torch.bfloat16):
        raise ValueError(f"pcm_fused: variant {variant!r} cannot take {f.dtype} features "
                         f"of width {cf}")
    variant = variant or chosen
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
    mask_ptr = None if mask32 is None else mask32.data_ptr()
    out = torch.empty((n, hw, c), dtype=torch.float32, device=cam.device)

    launch = _launchers()[variant]
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream(cam.device).cuda_stream
        if variant == "mma":
            cfp = -(-cf // 64) * 64
            fn = torch.empty((n, hw, cfp), dtype=torch.bfloat16, device=cam.device)
            v = torch.empty((n, hw, 48), dtype=torch.bfloat16, device=cam.device)
            err = launch(cam32.data_ptr(), f.data_ptr(), mask_ptr, fn.data_ptr(), v.data_ptr(),
                         out.data_ptr(), n, hw, c, cf, cfp, float(eps), stream)
        else:
            scale = torch.empty((n, hw), dtype=torch.float32, device=cam.device)
            err = launch(cam32.data_ptr(), f.data_ptr(), int(f.dtype == torch.bfloat16),
                         mask_ptr, scale.data_ptr(), out.data_ptr(), n, hw, c, cf, float(eps),
                         stream)
    if err != 0:
        raise RuntimeError(f"pcm_fused: CUDA launch ({variant}) failed with cudaError_t {err}")
    launches += 1
    variant_launches[variant] += 1
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
