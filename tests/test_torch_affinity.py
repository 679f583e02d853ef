"""The port's AffinityNet (models/affinity.py) against the JAX package's at
full width, with the same weights, on the CPU in float32; and the weights'
way in: `state_dict_from_jax`, the JAX package's `convert_torch_state_dict`
back, and `merge_state_dict` for a stage-1 net's weights. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, random_jax_variables
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu.ops.pairs import dense_affinity_matrix as jax_dense_affinity_matrix
from wseg_tpu.ops.pairs import radius_pair_indices
from wseg_tpu.utils.checkpoint import convert_torch_state_dict
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.affinity import clamped_radius
from wseg_tpu_torch.ops.pairs import search_offsets
from wseg_tpu_torch.utils.checkpoint import merge_state_dict, state_dict_from_jax


@pytest.fixture(scope="module")
def aff_models():
    jmodel = jax_build_model("affinity")
    variables = random_jax_variables(jmodel, (1, 64, 64, 3), seed=7)
    tmodel = build_model("affinity", device="cpu").eval()
    tmodel.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, variables, tmodel


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


HWS = [(64, 64), (96, 128)]


@pytest.fixture(scope="module")
def jax_affinities(aff_models):
    """JAX pair affinities of a batch of 2 at 64x64 and at 96x128."""
    jmodel, variables, _ = aff_models
    apply = jax.jit(jmodel.apply)
    out = {}
    for hw in HWS:
        x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
        out[hw] = x, np.asarray(apply(variables, jnp.asarray(x)))
    return out


@pytest.mark.parametrize("hw", HWS)
def test_affinity_net_matches_jax(aff_models, jax_affinities, hw):
    """Pair affinities of a batch of 2 within atol 1e-4 x max: 64x64 gives an
    8x8 map (radius clamped to 3), 96x128 a 12x16 map (radius 5)."""
    tmodel = aff_models[2]
    x, want = jax_affinities[hw]
    with torch.no_grad():
        got = tmodel(_nchw(x)).numpy()
    h8, w8 = hw[0] // 8, hw[1] // 8
    r = clamped_radius(h8, w8, 5)
    assert r == (3 if hw == (64, 64) else 5)
    n_pairs = (h8 - r + 1) * (w8 - 2 * r + 2)
    assert got.shape == want.shape == (2, len(search_offsets(r)), n_pairs)
    assert _rel_err(got, want) <= 1e-4


def test_gather_pair_impl_and_dense_matrix(aff_models, jax_affinities):
    """pair_impl "gather" gives the sliced affinities within 1e-6, and
    to_dense the JAX dense matrix of the JAX affinities within atol 1e-4 x
    max."""
    tmodel = aff_models[2]
    x, want_aff = jax_affinities[(64, 64)]
    gather = build_model("affinity", device="cpu", pair_impl="gather").eval()
    gather.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        sliced_aff, gather_aff = tmodel(_nchw(x)), gather(_nchw(x))
        dense = tmodel(_nchw(x[:1]), to_dense=True).numpy()
    torch.testing.assert_close(gather_aff, sliced_aff, rtol=0, atol=1e-6)
    want = np.asarray(jax_dense_affinity_matrix(want_aff[0], *radius_pair_indices(3, (8, 8)),
                                                64))
    assert dense.shape == want.shape == (64, 64)
    assert _rel_err(dense, want) <= 1e-4
    with pytest.raises(ValueError, match="per image"):
        tmodel(torch.zeros(2, 3, 64, 64), to_dense=True)
    with pytest.raises(ValueError, match="pair_impl"):
        build_model("affinity", device="cpu", pair_impl="banded")


def test_weights_cross_both_ways(aff_models):
    """The JAX tree -> state_dict -> the JAX package's converter gives the
    tree back exactly; the keys are the reference's `resnet38_aff` keys
    (heads at the top level). (A JAX `.ckpt` of AffinityNet loads through
    `load_weights` in tests/test_torch_stage2_cli.py.)"""
    _, variables, tmodel = aff_models
    sd = tmodel.state_dict()
    assert {"f8_3.weight", "f8_4.weight", "f8_5.weight", "f9.weight", "conv1a.weight",
            "b7.conv_branch2b2.weight", "bn7.running_var"} <= sd.keys()
    assert tuple(sd["f9.weight"].shape) == (448, 448, 1, 1)
    params, stats = convert_torch_state_dict(sd)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path({"params": params, "batch_stats": stats}),
            jax.tree_util.tree_leaves_with_path(dict(variables))):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_state_dict_takes_a_contrast_net(capsys):
    """A stage-1 state_dict into AffinityNet: the trunk and f8_3 / f8_4 load,
    f9 (195 -> 192 there, 448 -> 448 here) and f8_5 keep their init, and the
    matched count is printed; with no overlap it warns."""
    contrast = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(3))
    aff = build_model("affinity", device="cpu")
    init = {k: v.clone() for k, v in aff.state_dict().items()}
    merged = merge_state_dict(aff.state_dict(), contrast.state_dict(), what="entries from x")
    aff.load_state_dict(merged, strict=True)
    csd, asd = contrast.state_dict(), aff.state_dict()
    for k in ("conv1a.weight", "b7.conv_branch2a.weight", "f8_3.weight", "f8_4.weight"):
        torch.testing.assert_close(asd[k], csd[k], rtol=0, atol=0)
    for k in ("f9.weight", "f8_5.weight"):
        torch.testing.assert_close(asd[k], init[k], rtol=0, atol=0)
    shared = sum(1 for k, v in init.items() if k in csd and csd[k].shape == v.shape)
    assert f"merged {shared}/{len(init)} entries from x" in capsys.readouterr().out
    with pytest.warns(UserWarning, match="no entries"):
        merge_state_dict(aff.state_dict(), {"x.weight": torch.zeros(1)}, what="entries")
