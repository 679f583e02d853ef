import torch

from wseg_tpu_torch.models.affinity import AffinityNet
from wseg_tpu_torch.models.contrast import ContrastNet
from wseg_tpu_torch.utils.device import resolve_device
from wseg_tpu_torch.utils.registry import MODELS

__all__ = ["AffinityNet", "ContrastNet", "build_model"]


def build_model(name: str, device: str | torch.device = "cuda", **kwargs):
    """Build a registered model by name on `device` (the GPU unless the caller
    passes "cpu"; channels_last memory format on CUDA). Accepts the
    reference's importlib strings (e.g. `network.resnet38_contrast`) and
    short names."""
    device = resolve_device(device)
    aliases = {
        "network.resnet38_contrast": "contrast",
        "network.resnet38_SEAM": "seam",
        "network.resnet38_aff": "affinity",
    }
    model = MODELS.get(aliases.get(name, name))(**kwargs).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
