"""The port's pair machinery (ops/pairs.py, ops/resize.py:avg_pool2d) and
the affinity targets (data/affinity_labels.py) against the JAX package's,
on the CPU in float32, from the same numpy-seeded inputs. Each test states
its tolerance."""

import numpy as np
import pytest
import torch

from wseg_tpu.data.affinity_labels import ExtractAffinityLabelInRadius as JaxExtract
from wseg_tpu.ops import pairs as jp
from wseg_tpu.ops.resize import avg_pool2d as jax_avg_pool2d
from wseg_tpu_torch.data.affinity_labels import ExtractAffinityLabelInRadius
from wseg_tpu_torch.ops import pairs as tp
from wseg_tpu_torch.ops.resize import avg_pool2d

# (radius, (h, w)): every radius 2-5, a non-square grid, and the clamp of a
# 64x64 input's 8x8 map (radius 3)
GRIDS = [(2, (6, 7)), (3, (8, 8)), (3, (10, 14)), (4, (9, 12)), (5, (12, 16)), (5, (11, 11))]


@pytest.mark.parametrize("radius,size", GRIDS)
def test_pair_indices_equal_jax(radius, size):
    """Offsets and indices equal exactly."""
    assert tp.search_offsets(radius) == jp.search_offsets(radius)
    for got, want in zip(tp.radius_pair_indices(radius, size),
                         jp.radius_pair_indices(radius, size)):
        np.testing.assert_array_equal(got, want)


def test_radius_below_two_raises_like_jax():
    f = torch.zeros(1, 8, 4, 4)
    for call in (lambda: tp.radius_pair_indices(1, (4, 4)),
                 lambda: tp.pairwise_affinity_sliced(f, 1)):
        with pytest.raises(ValueError, match="empty pair set"):
            call()


def _features(seed, n, c, h, w):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


@pytest.mark.parametrize("radius,size", GRIDS)
def test_pair_affinities_match_jax(radius, size):
    """Gather and sliced forms against JAX's, atol 1e-6; equal to each other
    within 1e-6 (the mean over channels sums in another order)."""
    h, w = size
    f = _features(radius, 2, 6, h, w)
    ind_from, ind_to = jp.radius_pair_indices(radius, size)
    want = np.asarray(jp.pairwise_affinity(f.reshape(2, h * w, 6), ind_from, ind_to))
    ft = torch.from_numpy(f).permute(0, 3, 1, 2)
    got_g = tp.pairwise_affinity(ft, *tp.pair_index_tensors(radius, size, "cpu")).numpy()
    got_s = tp.pairwise_affinity_sliced(ft, radius).numpy()
    assert got_g.shape == got_s.shape == want.shape
    np.testing.assert_allclose(got_g, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_s, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_s, got_g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius,size", GRIDS)
def test_dense_matrices_match_jax(radius, size):
    """The scatter and banded matrices equal each other exactly, batched or
    not, and JAX's scatter matrix within atol 1e-6 (exactly here: the same
    affinities go in)."""
    h, w = size
    ind_from, ind_to = jp.radius_pair_indices(radius, size)
    rng = np.random.RandomState(10 + radius)
    aff = rng.rand(3, len(ind_to) // len(ind_from), len(ind_from)).astype(np.float32)
    at = torch.from_numpy(aff)
    scatter = tp.dense_affinity_matrix(at, *tp.pair_index_tensors(radius, size, "cpu"), h * w)
    banded = tp.dense_affinity_matrix_banded(at, radius, size)
    torch.testing.assert_close(banded, scatter, rtol=0, atol=0)
    for i in range(3):
        want = np.asarray(jp.dense_affinity_matrix(aff[i], ind_from, ind_to, h * w))
        np.testing.assert_allclose(scatter[i].numpy(), want, rtol=0, atol=1e-6)
        single = tp.dense_affinity_matrix_banded(at[i], radius, size)
        torch.testing.assert_close(single, banded[i], rtol=0, atol=0)


def test_sliced_affinity_gradient_at_ties_matches_jax():
    """|ft - ff| at an exact tie has gradient +1 in JAX (torch.abs gives 0):
    the port's pair affinities give JAX's gradient, within 1e-6, on a map
    whose left half is constant, as in a crop's pad region."""
    import jax
    import jax.numpy as jnp

    f = _features(0, 1, 4, 8, 10)
    f[:, :, :5] = 0.25
    g = np.random.RandomState(1).randn(*jp.pairwise_affinity_sliced(f, 3).shape)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jp.pairwise_affinity_sliced(x, 3) * g))(f))
    ft = torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True)
    (tp.pairwise_affinity_sliced(ft, 3) * torch.from_numpy(g)).sum().backward()
    got = ft.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want[:, :, :5]).max() > 0  # the ties do carry gradient


def test_avg_pool2d_matches_jax():
    x = _features(5, 2, 3, 16, 24)
    want = np.asarray(jax_avg_pool2d(x, 8))
    got = avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        avg_pool2d(torch.zeros(1, 1, 12, 16), 8)


@pytest.mark.parametrize("cropsize,radius", [(56, 5), (8, 5), (6, 5), (11, 3)])
def test_affinity_labels_equal_jax(cropsize, radius):
    """The targets (bg_pos, fg_pos, neg) equal exactly, clamped radius too."""
    rng = np.random.RandomState(cropsize)
    label = rng.choice([0, 3, 7, 255], size=(cropsize, cropsize)).astype(np.uint8)
    got, want = ExtractAffinityLabelInRadius(cropsize, radius), JaxExtract(cropsize, radius)
    assert got.radius == want.radius
    for a, b in zip(got(label), want(label)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
