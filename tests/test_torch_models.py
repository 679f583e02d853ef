"""The port's models against the JAX package's with the same weights.

The JAX trees get their shapes from `jax.eval_shape(model.init, ...)` and
their values from np.random.RandomState (He-scaled kernels, randomized frozen
BN), and cross into the port through `state_dict_from_jax`. f32 on the CPU;
the JAX ContrastNet uses its XLA PCM (fused_pcm=False), the port its plain
PCM (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu.models import resnet38 as jr
from wseg_tpu.utils.checkpoint import convert_torch_state_dict, save_checkpoint
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models import resnet38 as tr
from wseg_tpu_torch.utils.checkpoint import load_weights, state_dict_from_jax


def random_jax_variables(module, x_shape, seed=0, **init_kw):
    """A random variables tree of `module`'s shapes, without running init:
    He-normal kernels, BN affine ~ N(1, .2) / N(0, .2), mean ~ N(0, .5),
    var ~ U(.5, 2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32), **init_kw)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:3]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.2, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.2, s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model_from_jax(variables):
    model = build_model("contrast", device="cpu").eval()
    model.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def contrast_vars():
    return random_jax_variables(jax_build_model("contrast"), (1, 32, 32, 3), seed=0)


# (kind, in, mid, out, stride, first_dilation, dilation)
BLOCKS = [
    ("basic", 8, 8, 16, 2, None, 1),
    ("basic", 8, 8, 8, 1, None, 1),
    ("basic", 8, 8, 16, 1, 1, 2),
    ("basic", 16, 8, 16, 1, None, 4),
    ("bot", 8, None, 16, 1, None, 4),
    ("bot", 8, None, 16, 2, None, 1),
    ("bot", 16, None, 32, 1, None, 2),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", BLOCKS, ids=lambda c: "-".join(map(str, c)))
def test_blocks_match_jax(cfg, masked):
    kind, cin, mid, cout, stride, fd, dil = cfg
    if kind == "basic":
        jblock = jr.ResBlock(cin, mid, cout, stride=stride, first_dilation=fd, dilation=dil)
        tblock = tr.ResBlock(cin, mid, cout, stride=stride, first_dilation=fd, dilation=dil)
    else:
        jblock = jr.ResBlockBot(cin, cout, stride=stride, dilation=dil, dropout=0.3)
        tblock = tr.ResBlockBot(cin, cout, stride=stride, dilation=dil, dropout=0.3)
    n, h, w = 2, 13, 18
    variables = random_jax_variables(jblock, (n, h, w, cin), seed=cin + cout + dil)
    tblock.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    tblock.eval()

    x = np.random.RandomState(1).randn(n, h, w, cin).astype(np.float32)
    kw_j, kw_t = {}, {}
    if masked:
        valid = np.array([[13, 18], [9, 11]], np.int32)
        ho, wo = -(-h // stride), -(-w // stride)
        kw_j = dict(mask_in=jr.valid_mask(jnp.asarray(valid), (h, w), 1),
                    mask_out=jr.valid_mask(jnp.asarray(valid), (ho, wo), stride))
        vt = torch.from_numpy(valid)
        kw_t = dict(mask_in=tr.valid_mask(vt, (h, w), 1),
                    mask_out=tr.valid_mask(vt, (ho, wo), stride))
    want, want_bn = jblock.apply(variables, jnp.asarray(x), get_x_bn_relu=True, **kw_j)
    with torch.inference_mode():
        got, got_bn = tblock(_nchw(x), get_x_bn_relu=True, **kw_t)
    assert _rel_err(_nhwc(got), np.asarray(want)) <= 1e-5
    assert _rel_err(_nhwc(got_bn), np.asarray(want_bn)) <= 1e-5


def test_contrast_net_matches_jax(contrast_vars):
    jmodel = jax_build_model("contrast", fused_pcm=False)
    tmodel = port_model_from_jax(contrast_vars)
    x = np.random.RandomState(2).randn(2, 32, 48, 3).astype(np.float32)

    want = jax.jit(lambda v, x: jmodel.apply(v, x))(contrast_vars, jnp.asarray(x))
    want_raw = jax.jit(lambda v, x: jmodel.apply(v, x, raw_cam=True))(contrast_vars, jnp.asarray(x))
    with torch.inference_mode():
        got = tmodel(_nchw(x))
        got_raw = tmodel(_nchw(x), raw_cam=True)
    for name, g, wnt in zip(["cam", "cam_rv", "f_proj", "cam_rv_down"], got, want):
        assert g.shape == _nchw(np.asarray(wnt)).shape, name
        assert _rel_err(_nhwc(g), np.asarray(wnt)) <= 1e-4, name
    for g, wnt in zip(got_raw, want_raw):
        assert _rel_err(_nhwc(g), np.asarray(wnt)) <= 1e-4


def test_contrast_net_valid_hw_matches_jax(contrast_vars):
    """A zero-padded batch with two valid sizes (the bucketed path)."""
    jmodel = jax_build_model("contrast", fused_pcm=False)
    tmodel = port_model_from_jax(contrast_vars)
    x = np.random.RandomState(3).randn(2, 48, 64, 3).astype(np.float32)
    valid = np.array([[41, 59], [30, 37]], np.int32)
    for i, (vh, vw) in enumerate(valid):
        x[i, vh:] = 0.0
        x[i, :, vw:] = 0.0
    want = jax.jit(lambda v, x, m: jmodel.apply(v, x, raw_cam=True, valid_hw=m))(
        contrast_vars, jnp.asarray(x), jnp.asarray(valid))
    with torch.inference_mode():
        got = tmodel(_nchw(x), raw_cam=True, valid_hw=torch.from_numpy(valid))
    for g, wnt in zip(got, want):
        assert _rel_err(_nhwc(g), np.asarray(wnt)) <= 1e-4
    assert float(got[1][1, :, 4:].abs().max()) == 0.0  # pad halo of sample 1


def test_state_dict_round_trip(contrast_vars):
    """Port keys are the reference's: the JAX package's own converter maps a
    port state_dict back to the same tree, bit for bit."""
    tmodel = port_model_from_jax(contrast_vars)
    sd = tmodel.state_dict()
    assert "conv1a.weight" in sd and "b4_3.bn_branch2a.running_var" in sd
    assert "fc8.weight" in sd and "f9.weight" in sd
    assert not any(k.startswith("backbone.") for k in sd)
    params, stats = convert_torch_state_dict(sd)
    for a, b in ((params, contrast_vars["params"]), (stats, contrast_vars["batch_stats"])):
        la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, va), (_, vb) in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=str(p))


def test_load_jax_ckpt(contrast_vars, tmp_path):
    path = str(tmp_path / "w.ckpt")
    save_checkpoint(path, {"params": contrast_vars["params"],
                           "batch_stats": contrast_vars["batch_stats"]})
    sd = load_weights(path)
    want = state_dict_from_jax(contrast_vars["params"], contrast_vars["batch_stats"])
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    build_model("contrast", device="cpu").load_state_dict(sd, strict=True)


def test_load_jax_ckpt_bf16(tmp_path):
    params = {"fc8": {"kernel": jnp.asarray(
        np.random.RandomState(4).randn(1, 1, 4, 3), jnp.bfloat16)}}
    path = str(tmp_path / "bf16.ckpt")
    save_checkpoint(path, {"params": params, "batch_stats": {}})
    got = load_weights(path)["fc8.weight"]
    want = np.asarray(params["fc8"]["kernel"].astype(jnp.float32)).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_pth_drops_bn_counters(tmp_path):
    model = build_model("network.resnet38_contrast", device="cpu",
                        generator=torch.Generator().manual_seed(5))
    sd = dict(model.state_dict())
    sd["b2.bn_branch2a.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "w.pth")
    torch.save(sd, path)
    loaded = load_weights(path)
    assert "b2.bn_branch2a.num_batches_tracked" not in loaded
    build_model("contrast", device="cpu").load_state_dict(loaded, strict=True)
