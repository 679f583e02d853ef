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
from wseg_tpu_torch.models.layers import (DilatedConv2d, _DilatedConvK2, conv, k2_grads_take,
                                           k2_takes)
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


@pytest.mark.parametrize("pixels,want", [
    (8 * 56 * 56, (True, True)),      # b6 / b7 at crop 448, batch 8 (stage 1)
    (10 * 56 * 56, (True, True)),     # seg_train's batch 10
    (layers.K2_MIN_DGRAD_PIXELS, (True, True)),
    (layers.K2_MIN_DGRAD_PIXELS - 1, (False, True)),
    (2 * 56 * 56, (False, True)),     # the training CLI's batch 2
    (layers.K2_MIN_WGRAD_PIXELS, (False, True)),
    (layers.K2_MIN_WGRAD_PIXELS - 1, (False, False)),
    (8 * 16 * 16, (False, False)),    # the 128 view
])
def test_k2_grads_take(pixels, want):
    assert k2_grads_take(pixels) == want


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


@pytest.mark.parametrize("needs,pixels,want", [
    ((True, True), 2 * 6 * 7, (2, 0)),
    ((True, False), 2 * 6 * 7, (1, 0)),
    ((False, True), 2 * 6 * 7, (1, 0)),
    ((True, True), layers.K2_MIN_DGRAD_PIXELS, (2, 2)),
    ((True, True), layers.K2_MIN_WGRAD_PIXELS, (2, 1)),
    ((False, True), layers.K2_MIN_WGRAD_PIXELS, (1, 1)),
])
def test_backward_counters_under_a_profiler(monkeypatch, needs, pixels, want):
    """The backward counts each gradient asked for as conv.dil4_bwd_grads and
    each that k2_grads_take gives K2 as conv.dil4_bwd_k2 (its output pixels
    stood in for by `pixels`); the gradients are autograd's of F.conv2d
    whichever way they ran."""
    monkeypatch.setattr(layers, "k2_grads_take", lambda _: k2_grads_take(pixels))
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 6, 7, generator=gen, requires_grad=needs[0])
    w = torch.randn(5, 3, 3, 3, generator=gen, requires_grad=needs[1])
    leaves = [t for t in (x, w) if t.requires_grad]
    profiling.reset()
    with torch.profiler.profile():
        got = torch.autograd.grad(_DilatedConvK2.apply(x, w, 4).square().sum(), leaves)
    counted = dict(profiling.counters)
    profiling.reset()
    assert (counted["conv.dil4_bwd_grads"], counted["conv.dil4_bwd_k2"]) == want
    wanted = torch.autograd.grad(F.conv2d(x, w, padding=4, dilation=4).square().sum(), leaves)
    for a, b in zip(got, wanted):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


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


# (x (B, CI, H, W), CO, dtype): f32 at 7 x 9; float64 at 5 x 7, a map
# narrower than dilation 4's halo on both sides, with channels that are no
# multiple of 4
ENTRY_CASES = [((2, 5, 7, 9), 6, torch.float32), ((2, 3, 5, 7), 5, torch.float64)]


@pytest.mark.parametrize("entry", ["forward", "dgrad", "wgrad"])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,co,dtype", ENTRY_CASES)
def test_nchw_entry_cpu_route(entry, channels_last, shape, co, dtype):
    """conv3x3_dilated_nchw and its gradients' entry points on the CPU are
    the plain twins: F.conv2d's output and autograd's input and weight
    gradients of it, with no launch; the output and the input gradient are
    channels_last, the weight gradient (CO, CI, 3, 3); bf16 and bad shapes
    raise."""
    gen = torch.Generator().manual_seed(co)
    x = torch.randn(shape, generator=gen, dtype=dtype)
    w = torch.randn(co, shape[1], 3, 3, generator=gen, dtype=dtype)
    g = torch.randn(shape[0], co, *shape[2:], generator=gen, dtype=dtype)
    if channels_last:
        x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    x.requires_grad_(True)
    w.requires_grad_(True)
    want_out = F.conv2d(x, w, padding=4, dilation=4)
    want = dict(zip(("forward", "dgrad", "wgrad"),
                    (want_out, *torch.autograd.grad(want_out, (x, w), g))))[entry]
    x, w = x.detach(), w.detach()
    call = {"forward": lambda a, b, d=4: conv_cuda.conv3x3_dilated_nchw(a, b, d),
            "dgrad": lambda a, b, d=4: conv_cuda.conv3x3_dilated_dgrad(g, b, d),
            "wgrad": lambda a, b, d=4: conv_cuda.conv3x3_dilated_wgrad(a, g, d)}[entry]
    before = conv_cuda.launches
    got = call(x, w)
    assert conv_cuda.launches == before
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if entry == "wgrad":
        assert got.shape == w.shape and got.is_contiguous()
    else:
        assert got.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        call(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError):  # CI, CO or the batch disagree
        call(*{"forward": (x, w[:, :2]), "dgrad": (x, w[:2]), "wgrad": (x[:1], w)}[entry])
    with pytest.raises(ValueError):
        call(x, w, 0)


def test_function_gradcheck_on_cpu():
    """_DilatedConvK2's forward and backward on the CPU (the plain twins)
    pass gradcheck in float64 at a map narrower than the halo."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 5, 7, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(5, 3, 3, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: _DilatedConvK2.apply(a, b, 4), (x, w))
