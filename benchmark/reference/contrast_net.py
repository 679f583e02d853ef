"""The stage-1 contrast net as plain PyTorch functions of a state_dict.

A frozen copy of the net the benchmark measures, written from the published
description (Du et al., CVPR 2022, arXiv:2110.07110, network/resnet38_contrast.py;
ResNet-38 of Wu et al., arXiv:1611.10080, network/resnet38d.py):

- the WideResNet-38 trunk at output stride 8 (dilation 2 in b5*, 4 in b6 and
  b7), pre-activation blocks, BatchNorm frozen to its running statistics;
- `fc8` (4096 -> 21) CAM head, `fc_proj` (4096 -> 128) projection head;
- PCM: the CAM, normalised and background-completed, propagated through the
  column-normalised pixel affinity relu(fn fn^T) of f9 = conv(cat[image at
  stride 8, relu(f8_3(conv4)), relu(f8_4(conv5))]) (195 -> 192).

Every function takes the parameters as a dict keyed by the reference's
state_dict names, so the same code runs in float32, bfloat16 or on the meta
device (FLOP counting). Dropout draws its keep masks from `draw(shape)`, in
the order the modules run. Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
PCM_EPS = 1e-5
NUM_CLASSES = 21
PROJ_DIM = 128
CALIBRATE = "__calibrate__"
# the std of each residual branch's last conv, as a share of He's: a random
# net at He's std amplifies a rounding error about fourfold through the
# trunk, a trained one does not
RESIDUAL_SCALE = 0.1

# basic blocks: name, in, mid, out, stride, first dilation, dilation
BASIC = (
    ("b2", 64, 128, 128, 2, 1, 1), ("b2_1", 128, 128, 128, 1, 1, 1),
    ("b2_2", 128, 128, 128, 1, 1, 1),
    ("b3", 128, 256, 256, 2, 1, 1), ("b3_1", 256, 256, 256, 1, 1, 1),
    ("b3_2", 256, 256, 256, 1, 1, 1),
    ("b4", 256, 512, 512, 2, 1, 1), ("b4_1", 512, 512, 512, 1, 1, 1),
    ("b4_2", 512, 512, 512, 1, 1, 1), ("b4_3", 512, 512, 512, 1, 1, 1),
    ("b4_4", 512, 512, 512, 1, 1, 1), ("b4_5", 512, 512, 512, 1, 1, 1),
    ("b5", 512, 512, 1024, 1, 1, 2), ("b5_1", 1024, 512, 1024, 1, 2, 2),
    ("b5_2", 1024, 512, 1024, 1, 2, 2),
)
# bottleneck blocks: name, in, out, dilation, dropout rate
BOTTLENECK = (("b6", 1024, 2048, 4, 0.3), ("b7", 2048, 4096, 4, 0.5))
# heads: name, in, out, Xavier gain (None: He-normal)
HEADS = (("fc_proj", 4096, PROJ_DIM, 1.0), ("fc8", 4096, NUM_CLASSES, 1.0),
         ("f8_3", 512, 64, None), ("f8_4", 1024, 128, None), ("f9", 3 + 64 + 128, 192, 4.0))


def param_specs() -> list[tuple[str, tuple, str, float]]:
    """Every state_dict entry as (name, shape, kind, std): kind "normal"
    (zero mean, std), or "const" (every element = std). Convs are He-normal
    (std sqrt(2 / fan_in)), a residual branch's last conv at RESIDUAL_SCALE
    of it; the Xavier heads take the normal of Xavier's variance, gain *
    sqrt(2 / (fan_in + fan_out)); BN is the identity until `calibrate` sets
    its statistics."""
    specs = []

    def conv(name, cin, cout, k, gain=None, scale=1.0):
        fan_in, fan_out = cin * k * k, cout * k * k
        std = (math.sqrt(2.0 / fan_in) if gain is None
               else gain * math.sqrt(2.0 / (fan_in + fan_out)))
        specs.append((f"{name}.weight", (cout, cin, k, k), "normal", std * scale))

    def bn(name, c):
        for leaf, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            specs.append((f"{name}.{leaf}", (c,), "const", value))

    conv("conv1a", 3, 64, 3)
    for name, cin, mid, cout, stride, _, _ in BASIC:
        bn(f"{name}.bn_branch2a", cin)
        if cin != cout or stride != 1:
            conv(f"{name}.conv_branch1", cin, cout, 1)
        conv(f"{name}.conv_branch2a", cin, mid, 3)
        bn(f"{name}.bn_branch2b1", mid)
        conv(f"{name}.conv_branch2b1", mid, cout, 3, scale=RESIDUAL_SCALE)
    for name, cin, cout, _, _ in BOTTLENECK:
        bn(f"{name}.bn_branch2a", cin)
        conv(f"{name}.conv_branch1", cin, cout, 1)
        conv(f"{name}.conv_branch2a", cin, cout // 4, 1)
        bn(f"{name}.bn_branch2b1", cout // 4)
        conv(f"{name}.conv_branch2b1", cout // 4, cout // 2, 3)
        bn(f"{name}.bn_branch2b2", cout // 2)
        conv(f"{name}.conv_branch2b2", cout // 2, cout, 1, scale=RESIDUAL_SCALE)
    bn("bn7", 4096)
    for name, cin, cout, gain in HEADS:
        conv(name, cin, cout, 1, gain)
    return specs


def _bn(p, name, x):
    if p.get(CALIBRATE, False):  # set the running statistics from this input first
        p[f"{name}.running_mean"] = x.mean(dim=(0, 2, 3)).detach()
        p[f"{name}.running_var"] = x.var(dim=(0, 2, 3)).detach()
    scale = p[f"{name}.weight"] * torch.rsqrt(p[f"{name}.running_var"] + BN_EPS)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


@torch.no_grad()
def calibrate(p: dict, x) -> dict:
    """Statistics of a trained net on random weights, taken from images x in
    one float32 pass (TF32 off, deterministic cuDNN: the same numbers
    whatever flags the caller runs under). Each frozen BatchNorm gets the
    mean and variance of what reaches it, so every block sees unit-scale
    inputs; each 1x1 head (f8_3, f8_4, f9, fc8, fc_proj) loses the part of
    its weight along its mean input, so its outputs vary about 0 over the
    image rather than carry one offset everywhere (relu'd features share a
    large positive mean): CAMs then peak and vanish, and PCM's affinity
    tells regions apart, as a trained net's do. Returns a new dict."""
    q = dict(p, **{CALIBRATE: True})
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            d = trunk(q, x)
            del q[CALIBRATE]
            for name, tap in (("f8_3", "conv4"), ("f8_4", "conv5"), ("fc8", "conv6"),
                              ("fc_proj", "conv6")):
                _center(q, name, d[tap])
            h, w = d["conv6"].shape[-2:]
            f9_in = torch.cat([up(x, (h, w)), torch.relu(_conv(q, "f8_3", d["conv4"])),
                               torch.relu(_conv(q, "f8_4", d["conv5"]))], dim=1)
            _center(q, "f9", f9_in)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    return {k: q[k] for k in p}


def _center(p, name, x):
    """W <- W - (W mu) mu^T / |mu|^2 for the 1x1 conv `name`, mu the mean of
    its input x over batch and pixels."""
    mu = x.mean(dim=(0, 2, 3))
    w = p[f"{name}.weight"][:, :, 0, 0]
    w = w - torch.outer(w @ mu, mu) / (mu @ mu)
    p[f"{name}.weight"] = w[:, :, None, None].contiguous()


def _conv(p, name, x, stride=1, dilation=1):
    w = p[f"{name}.weight"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv2d(x, w, None, stride, pad, dilation)


def _dropout2d(x, rate, draw):
    """torch's channel dropout with an explicit key: keep where u >= rate."""
    if draw is None:
        return x
    u = draw((x.shape[0], x.shape[1], 1, 1))
    return x * ((u >= rate).to(x.dtype) / (1.0 - rate))


def _basic(p, name, x, stride, first_dilation, dilation, same_shape):
    a = torch.relu(_bn(p, f"{name}.bn_branch2a", x))
    branch1 = x if same_shape else _conv(p, f"{name}.conv_branch1", a, stride)
    b = _conv(p, f"{name}.conv_branch2a", a, stride, first_dilation)
    b = torch.relu(_bn(p, f"{name}.bn_branch2b1", b))
    b = _conv(p, f"{name}.conv_branch2b1", b, 1, dilation)
    return branch1 + b, a


def _bottleneck(p, name, x, dilation, rate, draw):
    a = torch.relu(_bn(p, f"{name}.bn_branch2a", x))
    branch1 = _conv(p, f"{name}.conv_branch1", a)
    b = _conv(p, f"{name}.conv_branch2a", a)
    b = torch.relu(_bn(p, f"{name}.bn_branch2b1", b))
    b = _conv(p, f"{name}.conv_branch2b1", _dropout2d(b, rate, draw), 1, dilation)
    b = torch.relu(_bn(p, f"{name}.bn_branch2b2", b))
    b = _conv(p, f"{name}.conv_branch2b2", _dropout2d(b, rate, draw))
    return branch1 + b, a


def trunk(p, x, draw=None) -> dict:
    """The stride-8 trunk: the conv4 / conv5 taps (the bn-relu inputs of b5 and
    b6) and conv6 = relu(bn7(b7))."""
    x = _conv(p, "conv1a", x)
    taps = {}
    for name, cin, _, cout, stride, fd, dil in BASIC:
        x, a = _basic(p, name, x, stride, fd, dil, cin == cout and stride == 1)
        if name == "b5":
            taps["conv4"] = a
    for name, _, _, dil, rate in BOTTLENECK:
        x, a = _bottleneck(p, name, x, dil, rate, draw)
        if name == "b6":
            taps["conv5"] = a
    taps["conv6"] = torch.relu(_bn(p, "bn7", x))
    return taps


def cam_bg_complete(cam, e: float = 1e-5):
    """The PCM seed: relu, divide by the spatial max, background = 1 - the
    foreground max, each pixel's foreground kept at its argmax class only."""
    cam = torch.relu(cam)
    cam = torch.relu(cam - e) / (cam.amax(dim=(2, 3), keepdim=True) + e)
    fg = cam[:, 1:]
    fg_max = fg.amax(dim=1, keepdim=True)
    fg = torch.where(fg < fg_max, torch.zeros_like(fg), fg)
    return torch.cat([1.0 - fg_max, fg], dim=1)


def pcm(cam, f, eps: float = PCM_EPS):
    """Propagate cam (N, C, h, w) through the affinity of f (N, Cf, h, w)."""
    n, cf, h, w = f.shape
    c = cam.shape[1]
    fv = f.permute(0, 2, 3, 1).reshape(n, h * w, cf)
    fv = fv / (torch.linalg.vector_norm(fv, dim=-1, keepdim=True) + eps)
    aff = torch.relu(torch.bmm(fv, fv.transpose(1, 2)))
    aff = aff / (aff.sum(dim=1, keepdim=True) + eps)
    v = cam.permute(0, 2, 3, 1).reshape(n, h * w, c).to(aff.dtype)
    out = torch.bmm(aff.transpose(1, 2), v)
    return out.reshape(n, h, w, c).permute(0, 3, 1, 2)


def up(x, hw, align_corners=True):
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def forward(p, x, *, draw=None, raw_cam=False, pcm_dtype=None):
    """The contrast net on x (N, 3, H, W). `draw` set = training mode (channel
    dropout in b6, b7 and before the heads). Returns (cam, cam_rv_down) with
    `raw_cam`, else (cam, cam_rv, f_proj, cam_rv_down), cam and cam_rv
    upsampled to the input size (align_corners=True). `pcm_dtype` runs PCM in
    another type than the trunk's (the bfloat16 control keeps it float32)."""
    h_in, w_in = x.shape[-2:]
    d = trunk(p, x, draw)
    fea = _dropout2d(d["conv6"], 0.5, draw)
    cam = _conv(p, "fc8", fea)
    h, w = cam.shape[-2:]
    seed = cam_bg_complete(cam.detach())
    f8_3 = torch.relu(_conv(p, "f8_3", d["conv4"].detach()))
    f8_4 = torch.relu(_conv(p, "f8_4", d["conv5"].detach()))
    f = _conv(p, "f9", torch.cat([up(x, (h, w)), f8_3, f8_4], dim=1))
    if pcm_dtype is not None:
        seed, f = seed.to(pcm_dtype), f.to(pcm_dtype)
    cam_rv_down = pcm(seed, f)
    if raw_cam:
        return cam, cam_rv_down
    f_proj = torch.relu(_conv(p, "fc_proj", fea))
    return up(cam, (h_in, w_in)), up(cam_rv_down, (h_in, w_in)), f_proj, cam_rv_down
