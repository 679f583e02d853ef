"""The port's random walk (ops/random_walk.py) against the JAX package's, on
the CPU, in float32 and with the bf16 squaring chain; and its refiner
(infer/rw.py): the pixel-budget sentinel, and bucketing, chunking and both
matrix forms, which never change an output. Inputs are numpy-seeded; each
test states its tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.ops.pairs import dense_affinity_matrix, radius_pair_indices
from wseg_tpu.ops.random_walk import random_walk_refine as jax_random_walk_refine
from wseg_tpu_torch.infer.rw import MAX_WALK_PX, MAX_WALK_PX_GATHER, RandomWalkRefiner
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.ops.random_walk import random_walk_refine


def _walk_inputs(seed, h=64, w=64, radius=3):
    """A CAM and a band-limited affinity of the walk's own pair structure."""
    rng = np.random.RandomState(seed)
    cam = rng.rand(h, w, 21).astype(np.float32)
    indf, indt = radius_pair_indices(radius, (h // 8, w // 8))
    vals = rng.rand(len(indt) // len(indf), len(indf)).astype(np.float32)
    return cam, np.array(dense_affinity_matrix(vals, indf, indt, (h // 8) * (w // 8)))


def _port_walk(cam, aff, **kw):
    out = random_walk_refine(torch.from_numpy(cam).permute(2, 0, 1), torch.from_numpy(aff), **kw)
    return out.permute(1, 2, 0).numpy()


@pytest.mark.parametrize("seed,hw,logt", [(0, (64, 64), 6), (1, (48, 80), 6), (2, (64, 64), 2)])
def test_random_walk_f32_matches_jax(seed, hw, logt):
    """float32: within rtol 1e-4 / atol 1e-6."""
    cam, aff = _walk_inputs(seed, *hw)
    want = np.asarray(jax_random_walk_refine(cam, aff, beta=8, logt=logt))
    got = _port_walk(cam, aff, beta=8, logt=logt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_random_walk_batched_equals_single():
    """A leading batch dim gives each image's own walk, within 1e-6."""
    pairs = [_walk_inputs(s) for s in (3, 4)]
    cams = torch.stack([torch.from_numpy(c).permute(2, 0, 1) for c, _ in pairs])
    affs = torch.stack([torch.from_numpy(a) for _, a in pairs])
    batched = random_walk_refine(cams, affs)
    for i, (cam, aff) in enumerate(pairs):
        np.testing.assert_allclose(batched[i].permute(1, 2, 0).numpy(), _port_walk(cam, aff),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_random_walk_bf16_matches_jax_bf16(seed):
    """The bf16 chain against JAX's bf16 chain: max difference <= 2^-7 x the
    scores' max, argmax agreement >= 99%."""
    cam, aff = _walk_inputs(seed)
    want = np.asarray(jax_random_walk_refine(cam, aff, beta=8, logt=6,
                                             compute_dtype=jnp.bfloat16))
    got = _port_walk(cam, aff, beta=8, logt=6, compute_dtype=torch.bfloat16)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_max_walk_px_sentinel():
    """None resolves by the model's pair form; an explicit value, even
    MAX_WALK_PX itself, is kept."""
    sliced = build_model("affinity", device="cpu")
    gather = build_model("affinity", device="cpu", pair_impl="gather")
    assert RandomWalkRefiner(sliced).max_walk_px == MAX_WALK_PX
    assert RandomWalkRefiner(gather).max_walk_px == MAX_WALK_PX_GATHER
    assert RandomWalkRefiner(gather, max_walk_px=123).max_walk_px == 123
    assert RandomWalkRefiner(gather, max_walk_px=MAX_WALK_PX).max_walk_px == MAX_WALK_PX
    with pytest.raises(ValueError, match="matrix_impl"):
        RandomWalkRefiner(sliced, matrix_impl="dense")


@pytest.fixture(scope="module")
def items():
    """Three images in two buckets (64x64 and 64x128 at bucket 64)."""
    rng = np.random.RandomState(9)
    out = []
    for h, w in [(60, 50), (64, 100), (41, 64)]:
        cam = rng.rand(h, w, 21).astype(np.float32)
        cam[..., 0] = 0.27
        out.append((rng.randn(h, w, 3).astype(np.float32), cam))
    return out


def test_refiner_chunking_and_matrix_forms_do_not_change_outputs(items):
    """refine_batch with one image per dispatch, with the banded matrix, and
    refine_one all give refine_batch's masks exactly; each mask is uint8 at
    its image's size."""
    model = build_model("affinity", device="cpu", generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # affinities of about (0.1, 0.5), not 0: the walk mixes
        model.f9.weight.mul_(0.01)
    want = RandomWalkRefiner(model, logt=3).refine_batch(items)
    for (im, _), m in zip(items, want):
        assert m.dtype == np.uint8 and m.shape == im.shape[:2] and m.max() <= 20
        assert len(np.unique(m)) > 1
    variants = [RandomWalkRefiner(model, logt=3, max_walk_px=64 * 64).refine_batch(items),
                RandomWalkRefiner(model, logt=3, matrix_impl="banded").refine_batch(items),
                [RandomWalkRefiner(model, logt=3).refine_one(*it) for it in items]]
    for got in variants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
