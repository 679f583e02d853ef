"""Device selection for the port's entry points: the GPU unless the caller
asks for the CPU, and an error, not a silent CPU run, when there is no GPU.
Under torchrun (LOCAL_RANK set) a bare "cuda" is this rank's card."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    return device
