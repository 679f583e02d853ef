"""The port's CUDA kernels (PCM, the dilated 3x3 conv) against their plain
versions on the card, and one training step there. These tests need an
NVIDIA GPU with nvcc and skip elsewhere; on the card they run with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports no JAX, so it also runs on a host without it."""

import pytest
import torch

from wseg_tpu_torch.kernels import conv_cuda, pcm_cuda
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain
from wseg_tpu_torch.ops.pcm import pcm, pcm_flat, pcm_flat_bf16
from wseg_tpu_torch.train.contrast import make_train_step
from wseg_tpu_torch.train.optim import PolySGD, param_groups

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,hw,cf,masked,f_dtype", [
    (2, 24 * 24, 192, False, torch.float32),
    (1, 700, 64, False, torch.float32),
    (2, 700, 192, True, torch.float32),
    (2, 1000, 192, False, torch.bfloat16),
    (3, 65, 7, True, torch.float32),
])
def test_pcm_kernel_matches_plain(cuda, n, hw, cf, masked, f_dtype):
    """Each variant against its plain twin: f32 features against pcm_flat,
    bf16 ones (the tensor-core kernel) against the bf16 rounding rule."""
    gen = torch.Generator(device=cuda).manual_seed(hw)
    f = torch.randn(n, hw, cf, generator=gen, device=cuda).to(f_dtype)
    cam = torch.rand(n, hw, 21, generator=gen, device=cuda)
    mask = (torch.rand(n, hw, generator=gen, device=cuda) > 0.3).float() if masked else None
    variant = pcm_cuda.pcm_variant(f.dtype, cf)
    before = pcm_cuda.launches, pcm_cuda.variant_launches[variant]
    got = pcm_cuda.pcm_fused(cam, f, mask=mask)
    torch.cuda.synchronize()
    assert (pcm_cuda.launches, pcm_cuda.variant_launches[variant]) == (before[0] + 1,
                                                                       before[1] + 1)
    plain = pcm_flat_bf16 if f_dtype == torch.bfloat16 else pcm_flat
    torch.testing.assert_close(got, plain(cam, f, mask=mask), rtol=2e-3, atol=2e-4)


# (n, hw, cf, c, masked): hw not a multiple of 64, masks, C = 1 and C = 23,
# feature widths across the register templates (64, 128, 192, 256 channels)
@pytest.mark.parametrize("n,hw,cf,c,masked", [
    (16, 3072, 192, 21, False),
    (2, 700, 192, 21, True),
    (3, 65, 7, 1, True),
    (2, 333, 256, 23, False),
    (1, 1000, 100, 23, True),
    (4, 1, 192, 21, False),
])
def test_pcm_mma_kernel_matches_rounding_rule(cuda, n, hw, cf, c, masked):
    gen = torch.Generator(device=cuda).manual_seed(hw + c)
    f = torch.randn(n, hw, cf, generator=gen, device=cuda).bfloat16()
    cam = torch.rand(n, hw, c, generator=gen, device=cuda)
    mask = (torch.rand(n, hw, generator=gen, device=cuda) > 0.3).float() if masked else None
    before = pcm_cuda.variant_launches["mma"]
    got = pcm_cuda.pcm_fused(cam, f, mask=mask)
    torch.cuda.synchronize()
    assert pcm_cuda.variant_launches["mma"] == before + 1
    torch.testing.assert_close(got, pcm_flat_bf16(cam, f, mask=mask), rtol=2e-3, atol=2e-4)


def test_pcm_fma_variant_takes_bf16_on_request(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    f = torch.randn(2, 300, 192, generator=gen, device=cuda).bfloat16()
    cam = torch.rand(2, 300, 21, generator=gen, device=cuda)
    before = pcm_cuda.variant_launches["fma"]
    got = pcm_cuda.pcm_fused(cam, f, variant="fma")
    torch.cuda.synchronize()
    assert pcm_cuda.variant_launches["fma"] == before + 1
    torch.testing.assert_close(got, pcm_flat(cam, f.float()), rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError):
        pcm_cuda.pcm_fused(cam, f.float(), variant="mma")


def test_pcm_kernel_nchw_masked(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn(2, 192, 12, 20, generator=gen, device=cuda)
    cam = torch.rand(2, 21, 12, 20, generator=gen, device=cuda)
    mask = torch.zeros(2, 1, 12, 20, device=cuda)
    mask[0, :, :9, :17] = 1.0
    mask[1, :, :12, :5] = 1.0
    got = pcm_cuda.pcm_fused_nchw(cam, f, mask=mask)
    torch.testing.assert_close(got, pcm(cam, f, mask=mask), rtol=2e-3, atol=2e-4)


def test_pcm_kernel_rejects_unsupported(cuda):
    with pytest.raises(ValueError):
        pcm_cuda.pcm_fused(torch.zeros(1, 8, 30, device=cuda), torch.zeros(1, 8, 4, device=cuda))
    with pytest.raises(TypeError):
        pcm_cuda.pcm_fused(torch.zeros(1, 8, 21, device=cuda),
                           torch.zeros(1, 8, 4, device=cuda, dtype=torch.float16))


# (x shape, CO, dilation, tile_co): the shapes of tests/test_conv_pallas.py,
# then tails (H not a multiple of d; CI, CO not multiples of 8 or of a tile)
# and several pixel and channel tiles
CONV_CASES = [
    ((2, 16, 16, 8), 16, 1, 16),
    ((2, 16, 16, 8), 16, 2, 16),
    ((2, 16, 16, 8), 16, 4, 16),
    ((1, 8, 8, 4), 32, 2, 8),
    ((1, 8, 8, 4), 32, 2, 32),
    ((2, 13, 19, 37), 150, 3, 64),
    ((2, 20, 30, 64), 264, 4, 256),
]


def _conv_inputs(device, shape, co, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    k = torch.randn((3, 3, shape[3], co), generator=gen, device=device) / (9 * shape[3]) ** 0.5
    return x.to(dtype), k.to(dtype)


@pytest.mark.parametrize("shape,co,d,tile_co", CONV_CASES)
def test_conv_kernel_matches_plain_f32(cuda, shape, co, d, tile_co):
    x, k = _conv_inputs(cuda, shape, co, torch.float32, seed=co + d)
    before = conv_cuda.launches
    got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tile_co)
    torch.cuda.synchronize()
    assert conv_cuda.launches == before + 1
    torch.testing.assert_close(got, conv3x3_dilated_plain(x, k, d), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co,d,tile_co", CONV_CASES + [
    ((2, 24, 32, 64), 256, 4, 128),
    ((2, 24, 32, 64), 256, 4, 512),
    ((1, 9, 11, 64), 13, 2, 256),   # CO odd: element-wise loads
])
def test_conv_kernel_matches_plain_bf16(cuda, shape, co, d, tile_co):
    """bf16 in, f32 accumulation, bf16 out (a relative step of 2^-8): held
    against the plain version in f32 on the same bf16 inputs. Each shape runs
    the variant that conv_variant picks for it."""
    x, k = _conv_inputs(cuda, shape, co, torch.bfloat16, seed=co + d)
    variant = conv_cuda.conv_variant(x.dtype, shape[3], co)
    before = conv_cuda.variant_launches[variant]
    got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tile_co).float()
    assert conv_cuda.variant_launches[variant] == before + 1
    want = conv3x3_dilated_plain(x.float(), k.float(), d)
    rms = float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * rms)


# (x shape, CO, dilation, tile_co) for the wgmma kernel: W not a multiple of
# the tile width, H tails, images whose H*W is no multiple of 128 (a row-major
# 128-pixel tiling would cross a batch boundary), dilations larger than the
# tile's height, CI a multiple of 8 but not of 64 (the channel tail is TMA's
# zero fill), and tile_co 64 / 128 / 256 / 512
WGMMA_CASES = [
    ((2, 12, 100, 64), 128, 2, 256),
    ((2, 13, 64, 64), 256, 3, 256),
    ((3, 5, 24, 64), 200, 9, 256),
    ((1, 20, 128, 64), 64, 6, 64),
    ((2, 13, 19, 40), 136, 5, 128),
    ((2, 13, 19, 72), 264, 3, 64),
    ((1, 3, 7, 8), 8, 1, 256),
    ((2, 20, 30, 64), 512, 4, 64),
    ((2, 20, 30, 64), 512, 4, 128),
    ((2, 20, 30, 64), 512, 4, 256),
    ((2, 20, 30, 64), 512, 4, 512),
    ((2, 20, 30, 64), 520, 4, 384),
]


@pytest.mark.parametrize("shape,co,d,tile_co", WGMMA_CASES)
def test_conv_wgmma_kernel_matches_plain(cuda, shape, co, d, tile_co):
    x, k = _conv_inputs(cuda, shape, co, torch.bfloat16, seed=sum(shape) + co)
    assert conv_cuda.conv_variant(x.dtype, shape[3], co) == "wgmma"
    before = conv_cuda.variant_launches["wgmma"]
    got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tile_co).float()
    torch.cuda.synchronize()
    assert conv_cuda.variant_launches["wgmma"] == before + 1
    want = conv3x3_dilated_plain(x.float(), k.float(), d)
    rms = float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * rms)


def test_conv_variants_agree_and_refuse(cuda):
    """mma_sync on request takes what wgmma takes and agrees with it; a
    misaligned x goes to mma_sync; wgmma cannot be asked of what TMA refuses."""
    x, k = _conv_inputs(cuda, (2, 16, 24, 64), 128, torch.bfloat16, seed=1)
    a = conv_cuda.conv3x3_dilated(x, k, dilation=2, variant="wgmma").float()
    b = conv_cuda.conv3x3_dilated(x, k, dilation=2, variant="mma_sync").float()
    rms = float(b.pow(2).mean().sqrt())
    torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2 * rms)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = flat[1:].view(x.shape)  # 2 bytes off the 16-byte alignment
    shifted.copy_(x)
    before = conv_cuda.variant_launches["mma_sync"]
    torch.testing.assert_close(conv_cuda.conv3x3_dilated(shifted, k, dilation=2).float(), b)
    assert conv_cuda.variant_launches["mma_sync"] == before + 1
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(shifted, k, dilation=2, variant="wgmma")
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x.float(), k.float(), variant="wgmma")


def test_conv_kernel_rejects_unsupported(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    k = torch.zeros(3, 3, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_dilated(x.half(), k.half())
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_dilated(x, k.bfloat16())
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, k[:, :, :3])
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, k[:2])
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, k, dilation=0)
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, k, tile_co=0)


def test_train_step_on_card(cuda):
    """One full-width dual-view step (crop 64, low_res 32, batch 2): finite
    losses, trainable parameters moved, frozen ones not."""
    model = build_model("contrast", device=cuda, generator=torch.Generator().manual_seed(0))
    opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
    step = make_train_step(model, opt, low_res=32, grad_clip=5.0,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    img = torch.randn(2, 3, 64, 64, generator=gen, device=cuda)
    label = torch.zeros(2, 20, device=cuda)
    label[0, 3] = label[1, 7] = 1
    fc8, conv1a = model.fc8.weight.detach().clone(), model.conv1a.weight.detach().clone()
    metrics = step(img, label)
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert not torch.equal(model.fc8.weight, fc8)
    assert torch.equal(model.conv1a.weight, conv1a)


@pytest.mark.parametrize("momentum", [0.1, 3e-4])
def test_batch_stats_bn_card_matches_cpu(cuda, momentum):
    """Stage 3's batch-statistics BN on the card against the CPU: the
    train-mode output within 1e-5 of its max, the running-stat update within
    1e-4 of its max plus one ulp of the stat, and the eval-mode output."""
    from wseg_tpu_torch.models.layers import BatchNorm2d

    gen = torch.Generator().manual_seed(int(momentum * 1e4))
    x = torch.randn(4, 24, 9, 11, generator=gen) * 1.7 + torch.randn(24, 1, 1, generator=gen)
    bns = {}
    for dev in ("cpu", cuda):
        bn = BatchNorm2d(24, frozen=False, momentum=momentum).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 24))
            bn.running_var.copy_(torch.linspace(0.5, 2.0, 24))
        bns[str(dev)] = (bn, bn.train()(x.to(dev)).detach().cpu())
    (bn_c, out_c), (bn_g, out_g) = bns["cpu"], bns[str(cuda)]
    assert float((out_g - out_c).abs().max()) <= 1e-5 * float(out_c.abs().max())
    for key, init in (("running_mean", torch.zeros(24)),
                      ("running_var", torch.linspace(0.5, 2.0, 24))):
        d_c, d_g = getattr(bn_c, key) - init, getattr(bn_g, key).cpu() - init
        ulp = float(torch.finfo(torch.float32).eps) * float(getattr(bn_c, key).abs().max())
        assert float((d_g - d_c).abs().max()) <= 1e-4 * float(d_c.abs().max()) + ulp, key
    with torch.no_grad():
        torch.testing.assert_close(bn_g.eval()(x.to(cuda)).cpu(), bn_c.eval()(x),
                                   rtol=1e-5, atol=1e-6)


def test_seg_train_step_card_matches_cpu(cuda):
    """One DeepLab v1 / ResNet-38 train-mode step at batch 2, 48x64, dropout
    off, on the card and on the CPU from the same weights: loss and every
    parameter within 1e-3 relative, the running stats moved on both."""
    from wseg_tpu_torch.models.layers import Dropout
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.optim import seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    gen = torch.Generator().manual_seed(2)
    img = torch.randn(2, 3, 48, 64, generator=gen)
    lab = torch.randint(0, 21, (2, 48, 64), generator=gen)
    lab[:, :5] = 255
    runs = {}
    for dev in ("cpu", cuda):
        model = generate_net(EXPERIMENTS["SEAM_deeplabv1_resnet38"], device=dev,
                             generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.cls_conv.weight.mul_(0.02)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        opt = PolySGD(param_groups(model, seg_label_params(model)), 1e-3, 5e-4, 100,
                      momentum=0.9)
        loss = float(make_seg_train_step(model, opt)(img.to(dev), lab.to(dev))["loss"])
        runs[str(dev)] = (loss, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (loss_c, sd_c), (loss_g, sd_g) = runs["cpu"], runs[str(cuda)]
    assert abs(loss_g - loss_c) <= 1e-3 * abs(loss_c)
    for k in sd_c:
        assert float((sd_g[k] - sd_c[k]).abs().max()) <= 1e-3 * float(sd_c[k].abs().max()), k
    assert float(sd_g["backbone.bn7.running_mean"].abs().max()) > 0
