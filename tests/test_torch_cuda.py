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
from wseg_tpu_torch.ops.pcm import pcm, pcm_flat
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
    gen = torch.Generator(device=cuda).manual_seed(hw)
    f = torch.randn(n, hw, cf, generator=gen, device=cuda).to(f_dtype)
    cam = torch.rand(n, hw, 21, generator=gen, device=cuda)
    mask = (torch.rand(n, hw, generator=gen, device=cuda) > 0.3).float() if masked else None
    before = pcm_cuda.launches
    got = pcm_cuda.pcm_fused(cam, f, mask=mask)
    torch.cuda.synchronize()
    assert pcm_cuda.launches == before + 1
    torch.testing.assert_close(got, pcm_flat(cam, f.float(), mask=mask), rtol=2e-3, atol=2e-4)


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
    against the plain version in f32 on the same bf16 inputs."""
    x, k = _conv_inputs(cuda, shape, co, torch.bfloat16, seed=co + d)
    got = conv_cuda.conv3x3_dilated(x, k, dilation=d, tile_co=tile_co).float()
    want = conv3x3_dilated_plain(x.float(), k.float(), d)
    rms = float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * rms)


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
