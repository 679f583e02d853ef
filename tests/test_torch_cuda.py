"""The PCM CUDA kernel against its plain version on the card. These tests
need an NVIDIA GPU with nvcc and skip elsewhere; on the card they run with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports no JAX, so it also runs on a host without it."""

import pytest
import torch

from wseg_tpu_torch.kernels import pcm_cuda
from wseg_tpu_torch.ops.pcm import pcm, pcm_flat

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
