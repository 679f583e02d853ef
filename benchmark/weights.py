"""Weights from the seed: every entry of a reference's `param_specs()` made on
the device in one draw, in float32, the type they are served in."""

from __future__ import annotations

import torch


def make(specs, generator: torch.Generator, device) -> dict:
    """{name: tensor} for specs [(name, shape, kind, value)]: "normal" entries
    are one standard-normal draw, split and scaled by each entry's std;
    "const" entries are filled with the value."""
    normal = [(n, s, v) for n, s, kind, v in specs if kind == "normal"]
    sizes = [torch.Size(s).numel() for _, s, _ in normal]
    z = torch.randn(sum(sizes), generator=generator, device=device, dtype=torch.float32)
    std = torch.repeat_interleave(torch.tensor([v for _, _, v in normal], device=device),
                                  torch.tensor(sizes, device=device))
    z = z * std
    out = {n: t.view(s) for (n, s, _), t in zip(normal, z.split(sizes))}
    for n, s, kind, v in specs:
        if kind == "const":
            out[n] = torch.full(s, float(v), device=device)
    return {n: out[n] for n, *_ in specs}


def contrast(seed: int, device) -> dict:
    """The contrast net's weights of `seed`: `make` over the reference's
    specs, then `contrast_net.calibrate` on two seed-made 128 x 128 crops."""
    from benchmark import traffic
    from benchmark.reference import contrast_net

    gen = torch.Generator(device=device).manual_seed(traffic.torch_seed(seed, 2))
    p = make(contrast_net.param_specs(), gen, device)
    x = traffic.crops(gen, 2, 128, device).permute(0, 3, 1, 2)
    return contrast_net.calibrate(p, x)
