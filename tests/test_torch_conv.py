"""K2, the dilated 3x3 conv, on the CPU: the port's plain version and its
kernel wrapper's CPU route against the JAX package's Pallas kernel in
interpret mode, at the shapes of tests/test_conv_pallas.py plus tails, within
rtol = atol = 1e-4 (f32); and the probe entry point at a tiny shape. The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.kernels.conv_pallas import conv3x3_dilated as jax_conv
from wseg_tpu_torch.cli import conv_probe
from wseg_tpu_torch.kernels import conv_cuda
from wseg_tpu_torch.ops.conv import conv3x3_dilated_plain

TOL = 1e-4


def _inputs(x_shape, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*x_shape).astype(np.float32)
    k = rng.randn(3, 3, x_shape[3], co).astype(np.float32)
    return x, k


# (x shape, CO, dilation, tile_co): tests/test_conv_pallas.py's shapes, then
# CI and CO that are no multiple of 8
@pytest.mark.parametrize("shape,co,d,tile_co", [
    ((2, 16, 16, 8), 16, 1, 16),
    ((2, 16, 16, 8), 16, 2, 16),
    ((2, 16, 16, 8), 16, 4, 16),
    ((1, 8, 8, 4), 32, 2, 8),
    ((1, 8, 8, 4), 32, 2, 32),
    ((1, 12, 10, 5), 7, 3, 7),
])
def test_conv_matches_pallas_interpret(shape, co, d, tile_co):
    x, k = _inputs(shape, co, seed=sum(shape) + co + d)
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(k), dilation=d, tile_co=tile_co,
                               interpret=True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    np.testing.assert_allclose(conv3x3_dilated_plain(xt, kt, d).numpy(), want, rtol=TOL, atol=TOL)
    before = conv_cuda.launches
    got = conv_cuda.conv3x3_dilated(xt, kt, dilation=d, tile_co=tile_co)
    assert conv_cuda.launches == before  # the CPU route is the plain version, no launch
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_conv_tail_beyond_the_pallas_kernel():
    """H not a multiple of d (which the Pallas kernel refuses), odd CI and CO:
    held against XLA's conv with the same semantics."""
    x, k = _inputs((2, 13, 19, 37), 150, seed=3)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), [(3, 3)] * 2, rhs_dilation=(3, 3),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv_cuda.conv3x3_dilated(torch.from_numpy(x), torch.from_numpy(k), dilation=3,
                                    tile_co=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_conv_bf16_plain_accumulates_in_f32():
    x, k = _inputs((1, 8, 8, 16), 8, seed=4)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    got = conv3x3_dilated_plain(xb, kb, 2)
    assert got.dtype == torch.bfloat16
    want = conv3x3_dilated_plain(xb.float(), kb.float(), 2)
    torch.testing.assert_close(got.float(), want, rtol=2**-8, atol=0)


def test_conv_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, torch.zeros(3, 3, 5, 16))
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, torch.zeros(1, 1, 4, 16))
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dilated(x, torch.zeros(3, 3, 4, 16), dilation=0)


def test_conv_probe_cli_on_cpu():
    results = conv_probe.main(["--device", "cpu", "--batch", "1", "--height", "8",
                               "--width", "12", "--ci", "16", "--co", "24", "--dilation", "2",
                               "--dtype", "float32"])
    assert [r["name"] for r in results] == ["library F.conv2d", "k2", "k2", "k2"]
    assert [r.get("tile_co") for r in results[1:]] == [128, 256, 512]
    for r in results[1:]:
        assert r["ms"] > 0 and r["max_abs_err"] <= 1e-4
