"""The card's published peaks, and what the card says of itself.

NVIDIA H100 data sheet, dense rates without sparsity, at the full power
limit: SXM 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s HBM3; PCIe 756, 378, 51 TFLOP/s and 2.0 TB/s.
A share of a peak is stated against these, with the power limit beside it.
"""

from __future__ import annotations

import subprocess

PEAKS = {
    "SXM": {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
    "PCIe": {"bf16_flops": 756e12, "tf32_flops": 378e12, "f32_flops": 51e12, "hbm_bytes": 2.0e12},
}


def of(card_name: str) -> dict:
    return PEAKS["PCIe" if "PCIe" in card_name else "SXM"]


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of card 0, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi rc {out.returncode}"
