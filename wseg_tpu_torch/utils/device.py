"""Device selection for the port's entry points: the GPU unless the caller
asks for the CPU, and an error, not a silent CPU run, when there is no GPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    return device
