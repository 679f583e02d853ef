"""The trunk's dilation-4 3x3 convs on K2 (models/layers.py:DilatedConv2d):
the rule that sends a call to K2's f32 kernel, the autograd Function around
it on the CPU (through K2's plain twin) against F.conv2d, the counters it
keeps, and ResNet-38's unchanged state_dict. The kernel itself runs only on
the card (tests/test_torch_cuda.py)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.kernels import conv_cuda
from wseg_tpu_torch.models import layers
from wseg_tpu_torch.models.layers import DilatedConv2d, _DilatedConvK2, conv, k2_takes
from wseg_tpu_torch.models.resnet38 import ResNet38
from wseg_tpu_torch.utils import profiling

HOLDS = dict(device_type="cuda", x_dtype=torch.float32, w_dtype=torch.float32, tf32=False,
             channels_last=True, out_channels=2048, pixels=8 * 56 * 56, autotune=False,
             kernel_size=(3, 3), stride=(1, 1), padding=(4, 4), dilation=(4, 4), groups=1,
             bias=False)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"tf32": True}, False),
    ({"x_dtype": torch.bfloat16, "w_dtype": torch.bfloat16}, False),
    ({"x_dtype": torch.bfloat16}, False),
    ({"dilation": (2, 2), "padding": (2, 2)}, False),
    ({"stride": (2, 2)}, False),
    ({"device_type": "cpu"}, False),
    ({"groups": 2}, False),
    ({"bias": True}, False),
    ({"padding": (2, 2)}, False),
    ({"kernel_size": (1, 1)}, False),
    ({"channels_last": False}, False),
    ({"out_channels": 512}, False),
    ({"out_channels": layers.K2_MIN_OUT_CHANNELS}, True),
    ({"pixels": 8 * 16 * 16}, True),
    ({"autotune": True}, True),
    ({"autotune": True, "pixels": 8 * 16 * 16}, False),
    ({"autotune": True, "pixels": layers.K2_MIN_AUTOTUNED_PIXELS}, True),
])
def test_k2_takes(change, want):
    assert k2_takes(**{**HOLDS, **change}) is want


@pytest.mark.parametrize("channels_last", [False, True])
def test_function_matches_conv2d_on_cpu(channels_last):
    """Forward and both gradients of a b7-like conv against F.conv2d at
    dilation 4, f32, from x in either memory format; the output is
    channels_last."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 12, 12, generator=gen)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(128, 64, 3, 3, generator=gen) / (9 * 64) ** 0.5
    x.requires_grad_(True)
    w.requires_grad_(True)
    got = _DilatedConvK2.apply(x, w, 4)
    want = F.conv2d(x, w, padding=4, dilation=4)
    g = torch.randn(want.shape, generator=gen)
    got_gx, got_gw = torch.autograd.grad(got, (x, w), g)
    want_gx, want_gw = torch.autograd.grad(want, (x, w), g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_gx, want_gx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_gw, want_gw, rtol=1e-5, atol=1e-5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert not got.is_contiguous()


def test_function_skips_the_gradients_not_asked_for():
    x = torch.randn(1, 8, 9, 10, requires_grad=True)
    w = torch.randn(16, 8, 3, 3)
    gx, = torch.autograd.grad(_DilatedConvK2.apply(x, w, 4).sum(), (x,))
    torch.testing.assert_close(gx, torch.autograd.grad(
        F.conv2d(x, w, padding=4, dilation=4).sum(), (x,))[0], rtol=1e-5, atol=1e-5)


def test_counters_under_a_profiler():
    """A CPU call reaches the rule (counted) and runs F.conv2d; the Function
    counts its call and its FLOPs; nothing counts outside a profiler."""
    layer = conv(8, 16, 3, dilation=4)
    x = torch.randn(2, 8, 6, 7)
    profiling.reset()
    layer(x)
    assert profiling.counters == {}
    with torch.profiler.profile():
        with torch.no_grad():
            out = layer(x)
            _DilatedConvK2.apply(x, layer.weight, 4)
    counted = dict(profiling.counters)
    profiling.reset()
    assert counted == {"conv.dil4_calls": 1, "conv.dil4_k2": 1,
                       "conv.dil4_flops": 2 * 9 * 8 * 16 * 2 * 6 * 7}
    torch.testing.assert_close(out, F.conv2d(x, layer.weight, padding=4, dilation=4))


def test_conv_returns_the_dilated_layer_for_dilation_4_only():
    assert type(conv(8, 16, 3, dilation=4)) is DilatedConv2d
    assert type(conv(8, 16, 3, dilation=2)) is nn.Conv2d
    assert type(conv(8, 16, 1, dilation=4)) is nn.Conv2d
    assert type(conv(8, 16, 3)) is nn.Conv2d


def test_resnet38_state_dict_is_unchanged(monkeypatch):
    """b6 / b7's dilated convs are DilatedConv2d; the state_dict's keys and
    shapes equal those of the trunk built of plain nn.Conv2d, and each loads
    the other's strictly."""
    torch.manual_seed(0)
    net = ResNet38()
    dilated = sorted(n for n, m in net.named_modules() if isinstance(m, DilatedConv2d))
    assert dilated == ["b6.conv_branch2b1", "b7.conv_branch2b1"]
    monkeypatch.setattr(layers, "DilatedConv2d", nn.Conv2d)
    plain = ResNet38()
    assert not any(isinstance(m, DilatedConv2d) for m in plain.modules())
    got, want = net.state_dict(), plain.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in want)
    plain.load_state_dict(got, strict=True)
    net.load_state_dict(plain.state_dict(), strict=True)


@pytest.mark.parametrize("channels_last", [False, True])
def test_nchw_entry_cpu_route(channels_last):
    """conv3x3_dilated_nchw on the CPU is the plain twin: F.conv2d's result,
    channels_last, no launch; bf16 and bad shapes raise."""
    x = torch.randn(2, 5, 7, 9)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(6, 5, 3, 3)
    before = conv_cuda.launches
    got = conv_cuda.conv3x3_dilated_nchw(x, w, 4)
    assert conv_cuda.launches == before
    torch.testing.assert_close(got, F.conv2d(x, w, padding=4, dilation=4), rtol=1e-5, atol=1e-5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_dilated_nchw(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated_nchw(x, w[:, :4])
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated_nchw(x, w, dilation=0)
