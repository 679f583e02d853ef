"""The kernels' dispatch on the CPU: which variant a CUDA call of each shape,
dtype and alignment runs (chosen before the launch, never by a failed
launch), which pixel tile the wgmma conv takes, and what raises."""

import pytest
import torch

from wseg_tpu_torch.kernels import conv_cuda, pcm_cuda


@pytest.mark.parametrize("dtype,ci,co,aligned,want", [
    (torch.bfloat16, 1024, 2048, True, "wgmma"),    # b6/b7, the probe
    (torch.bfloat16, 64, 264, True, "wgmma"),
    (torch.bfloat16, 40, 136, True, "wgmma"),       # CI % 64 != 0: TMA's zero fill
    (torch.bfloat16, 37, 150, True, "mma_sync"),    # CI % 8 != 0
    (torch.bfloat16, 64, 13, True, "mma_sync"),     # CO % 8 != 0
    (torch.bfloat16, 64, 256, False, "mma_sync"),   # x not 16-byte aligned
    (torch.float32, 1024, 2048, True, "fma"),
    (torch.float32, 37, 150, False, "fma"),
])
def test_conv_variant(dtype, ci, co, aligned, want):
    assert conv_cuda.conv_variant(dtype, ci, co, aligned) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_conv_variant_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        conv_cuda.conv_variant(dtype, 64, 64)


@pytest.mark.parametrize("ci,co,pixels,want", [
    (1024, 2048, 8 * 56 * 56, 1),   # b7: 1152 tiles fill four waves of 264 slots
    (1024, 2048, 8 * 16 * 16, 1),
    (512, 1024, 8 * 56 * 56, 4),    # b6: 288 tiles, the last wave fullest at 4
    (512, 1024, 10 * 56 * 56, 4),
    (512, 1024, 8 * 16 * 16, 2),    # 128 chunks of 16 pixels: at most 2 ranges of 64
    (512, 1024, 2 * 16 * 16, 1),    # 32 chunks: no split
    (37, 150, 2 * 5 * 7, 1),
    (512, 512, 4 * 64 * 64, 3),     # 144 tiles: 432 fill 82% of two waves of 264
])
def test_wgrad_split(ci, co, pixels, want):
    assert conv_cuda.wgrad_split(ci, co, pixels, 132) == want


@pytest.mark.parametrize("h,w,want", [
    (96, 128, (1, 128)),   # b7's maps: one row of 128
    (48, 64, (2, 64)),     # the probe's: 2 x 64
    (12, 100, (1, 128)),   # W below the tile width
    (13, 19, (4, 32)),
    (5, 24, (4, 32)),
    (1, 1, (1, 128)),
    (200, 16, (8, 16)),
])
def test_conv_tile_shape(h, w, want):
    th, tw = conv_cuda.conv_tile_shape(h, w)
    assert (th, tw) == want
    assert th * tw == 128 and tw in conv_cuda.TILE_WIDTHS


@pytest.mark.parametrize("dtype,cf,want", [
    (torch.bfloat16, 192, "mma"),  # the main path
    (torch.bfloat16, 7, "mma"),
    (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 257, "fma"),  # wider than the registers hold
    (torch.float32, 192, "fma"),
    (torch.float32, 7, "fma"),
])
def test_pcm_variant(dtype, cf, want):
    assert pcm_cuda.pcm_variant(dtype, cf) == want


def test_pcm_variant_refuses_other_dtypes():
    with pytest.raises(TypeError):
        pcm_cuda.pcm_variant(torch.float16, 64)


def test_reset_launches():
    pcm_cuda.variant_launches["mma"] += 2
    conv_cuda.variant_launches["wgmma"] += 3
    pcm_cuda.reset_launches()
    conv_cuda.reset_launches()
    assert pcm_cuda.launches == 0 and set(pcm_cuda.variant_launches.values()) == {0}
    assert conv_cuda.launches == 0 and set(conv_cuda.variant_launches.values()) == {0}
