"""The port's baseline SEAM net against the JAX package's SEAMNet with the
same weights, on the CPU in float32: both outputs, the no-gradient PCM
branch, the registry names and the weight bridge both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, _nhwc, _rel_err, random_jax_variables
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu.utils.checkpoint import convert_torch_state_dict
from wseg_tpu_torch.models import SEAMNet, build_model
from wseg_tpu_torch.utils.checkpoint import state_dict_from_jax


@pytest.fixture(scope="module")
def seam():
    """(JAX SEAMNet, its random variables, the port's net in eval mode with
    the same weights)."""
    jmodel = jax_build_model("seam")
    variables = random_jax_variables(jmodel, (1, 32, 32, 3), seed=11)
    tmodel = build_model("seam", device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                           strict=True)
    return jmodel, variables, tmodel


def test_seam_net_matches_jax(seam):
    """cam and the PCM-refined cam_rv at the input size (2 x 40 x 56),
    each within 1e-4 of its max."""
    jmodel, variables, tmodel = seam
    x = np.random.RandomState(12).randn(2, 40, 56, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(_nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 21, 40, 56)
        assert _rel_err(_nhwc(g), np.asarray(w)) <= 1e-4


def test_no_gradient_reaches_the_pcm_branch(seam):
    """cam_rv carries no gradient: a loss on both outputs trains fc8 and
    the trunk, never f9, f8_3 or f8_4 (the reference's torch.no_grad(), the
    JAX package's stop_gradient)."""
    _, _, tmodel = seam
    x = np.random.RandomState(13).randn(1, 32, 40, 3).astype(np.float32)
    cam, cam_rv = tmodel(_nchw(x))
    assert cam.requires_grad and not cam_rv.requires_grad and cam_rv.grad_fn is None
    tmodel.zero_grad(set_to_none=True)
    (cam.square().mean() + cam_rv.mean()).backward()
    for name in ("f9", "f8_3", "f8_4"):
        assert getattr(tmodel, name).weight.grad is None, name
    assert tmodel.fc8.weight.grad.abs().max() > 0
    assert tmodel.b7.conv_branch2a.weight.grad is not None
    tmodel.zero_grad(set_to_none=True)


def test_registry_names_and_bridge_round_trip(seam):
    """build_model takes "seam" and the reference's importlib string; the
    port's keys are resnet38_SEAM's (no fc_proj), and the JAX package's own
    converter maps them back to the same tree, bit for bit."""
    _, variables, tmodel = seam
    assert isinstance(build_model("network.resnet38_SEAM", device="cpu"), SEAMNet)
    sd = tmodel.state_dict()
    assert {"fc8.weight", "f8_3.weight", "f8_4.weight", "f9.weight"} <= sd.keys()
    assert not any(k.startswith(("fc_proj", "backbone.")) for k in sd)
    params, stats = convert_torch_state_dict(sd)
    for a, b in ((params, variables["params"]), (stats, variables["batch_stats"])):
        la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, va), (_, vb) in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=str(p))
