"""The port's ops (wseg_tpu_torch.ops, kernels/pcm_cuda.py on the CPU) against
the JAX package's on the same seeded inputs, f32 on the CPU. The port is NCHW,
the JAX package NHWC; inputs cross as numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.kernels.pcm_pallas import pcm_fused as jax_pcm_fused
from wseg_tpu.ops import cam as jcam
from wseg_tpu.ops.pcm import pcm as jax_pcm
from wseg_tpu.ops import resize as jres
from wseg_tpu_torch.kernels import pcm_cuda
from wseg_tpu_torch.ops import cam as tcam
from wseg_tpu_torch.ops import pcm as tpcm
from wseg_tpu_torch.ops import resize as tres


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((6, 8), (32, 48)), ((17, 23), (50, 31)), ((13, 9), (7, 5)), ((1, 5), (4, 3)),
    ((8, 8), (8, 8)),
])
def test_resize_bilinear(align_corners, in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(jres.resize_bilinear(jnp.asarray(x), out_hw, align_corners))
    got = _nhwc(tres.resize_bilinear(_nchw(x), out_hw, align_corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_hw,mid_hw,out_hw", [
    ((4, 6), (32, 48), (32, 48)), ((5, 7), (37, 51), (75, 101)), ((12, 16), (96, 128), (48, 64)),
])
def test_resize_bilinear_chain(in_hw, mid_hw, out_hw):
    x = np.random.RandomState(1).randn(3, *in_hw, 4).astype(np.float32)
    want = np.asarray(jres.resize_bilinear_chain(jnp.asarray(x), mid_hw, out_hw))
    got = _nhwc(tres.resize_bilinear_chain(_nchw(x), mid_hw, out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_valid(align_corners):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 64, 80, 3).astype(np.float32)
    valid_in = np.array([[64, 80], [41, 77], [1, 9]], np.int32)
    valid_out = (valid_in + 7) // 8
    want = np.asarray(jres.resize_bilinear_valid(
        jnp.asarray(x), (8, 10), jnp.asarray(valid_in), jnp.asarray(valid_out), align_corners))
    got = _nhwc(tres.resize_bilinear_valid(
        _nchw(x), (8, 10), torch.from_numpy(valid_in), torch.from_numpy(valid_out),
        align_corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(60, 45), (240, 180), (97, 61)])
def test_resize_bicubic(out_hw):
    img = (np.random.RandomState(3).rand(1, 120, 90, 3) * 255).astype(np.uint8)
    want = np.asarray(jres.resize_bicubic(jnp.asarray(img, jnp.float32), out_hw))
    got = _nhwc(tres.resize_bicubic(_nchw(img), out_hw))
    diff = np.abs(got - want)
    assert diff.max() <= 1.0  # 0..255 units: never more than 1/255 apart
    assert (diff == 0).mean() >= 0.999


def _cams(seed, shape=(2, 9, 11, 21)):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), (rng.rand(shape[0], *shape[1:3], 1) > 0.3)


def test_max_norm():
    x, _ = _cams(4)
    np.testing.assert_allclose(_nhwc(tcam.max_norm(_nchw(x))),
                               np.asarray(jcam.max_norm(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_max_onehot():
    x, _ = _cams(5)
    np.testing.assert_allclose(_nhwc(tcam.max_onehot(_nchw(x))),
                               np.asarray(jcam.max_onehot(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_cam_bg_complete(masked):
    x, m = _cams(6)
    m = m.astype(np.float32) if masked else None
    want = np.asarray(jcam.cam_bg_complete(
        jnp.asarray(x), mask=None if m is None else jnp.asarray(m)))
    got = _nhwc(tcam.cam_bg_complete(_nchw(x), mask=None if m is None else _nchw(m)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fuse_msf_cams():
    rng = np.random.RandomState(7)
    x = (rng.randn(20, 13, 17) * 3).astype(np.float32)
    x[4] = 0.0  # an absent class: the reference's constant -1 map
    want = np.asarray(jcam.fuse_msf_cams(jnp.asarray(x)))
    got = tcam.fuse_msf_cams(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the batched form (leading batch dim) is the per-image form stacked
    got_b = tcam.fuse_msf_cams(torch.from_numpy(np.stack([x, x * 2]))).numpy()
    np.testing.assert_allclose(got_b[1], np.asarray(jcam.fuse_msf_cams(jnp.asarray(x * 2))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_pcm_plain_matches_jax(masked):
    rng = np.random.RandomState(8)
    f = rng.randn(2, 12, 10, 32).astype(np.float32)
    cam = rng.rand(2, 6, 5, 21).astype(np.float32)
    m = (rng.rand(2, 12, 10, 1) > 0.25).astype(np.float32) if masked else None
    want = np.asarray(jax_pcm(jnp.asarray(cam), jnp.asarray(f),
                               mask=None if m is None else jnp.asarray(m)))
    got = _nhwc(tpcm.pcm(_nchw(cam), _nchw(f), mask=None if m is None else _nchw(m)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,hw,cf,bf16", [
    (2, 24 * 24, 192, False), (1, 700, 64, False), (1, 700, 192, True),
])
def test_pcm_plain_matches_pallas_kernel(n, hw, cf, bf16):
    """The plain version against the TPU kernel run in interpret mode, at the
    shapes of tests/test_pcm_pallas.py and its tolerance. With bf16 features
    both sides get the same bf16 f, and the plain side is the tensor-core
    kernel's rounding rule (fn rounded once to bf16), which is also what the
    CPU route of the kernel's wrapper runs."""
    rng = np.random.RandomState(9)
    f = rng.randn(n, hw, cf).astype(np.float32)
    cam = rng.rand(n, hw, 21).astype(np.float32)
    fj, ft = jnp.asarray(f), torch.from_numpy(f)
    if bf16:
        fj, ft = fj.astype(jnp.bfloat16), ft.bfloat16()
    want = np.asarray(jax_pcm_fused(jnp.asarray(cam), fj, interpret=True))
    plain = tpcm.pcm_flat_bf16 if bf16 else tpcm.pcm_flat
    got = plain(torch.from_numpy(cam), ft).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    if bf16:
        routed = pcm_cuda.pcm_fused(torch.from_numpy(cam), ft)
        np.testing.assert_array_equal(routed.numpy(), got)


@pytest.mark.parametrize("masked", [False, True])
def test_pcm_fused_cpu_is_plain(masked):
    """On a CPU tensor the wrapper is the plain version and launches nothing."""
    rng = np.random.RandomState(10)
    f = torch.from_numpy(rng.randn(2, 16, 10, 8).astype(np.float32))
    cam = torch.from_numpy(rng.rand(2, 21, 5, 4).astype(np.float32))
    m = torch.from_numpy((rng.rand(2, 1, 10, 8) > 0.3).astype(np.float32)) if masked else None
    before = pcm_cuda.launches
    got = pcm_cuda.pcm_fused_nchw(cam, f, mask=m)
    assert pcm_cuda.launches == before
    torch.testing.assert_close(got, tpcm.pcm(cam, f, mask=m), rtol=0, atol=0)


def test_pcm_fused_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pcm_cuda.pcm_fused(torch.zeros(1, 10, 21), torch.zeros(1, 9, 8))
    with pytest.raises(ValueError):
        pcm_cuda.pcm_fused(torch.zeros(10, 21), torch.zeros(10, 8))
