"""The rest of the port's stage-3 nets against the JAX package's with the
same weights: the undilated and 7x7-stem ResNets, Xception at output
strides 8 and 16, PPM, DeepLab v1-caffe, v3 and v3+ (on a resnet18 and on
Xception at full width), their parameter labels and the weight bridge.
Weights are numpy-seeded JAX trees carried across with
`seg_state_dict_from_jax`; f32 on the CPU. Tolerances are
tests/test_torch_seg_models.py's: eval logits within 1e-4 of their max,
bucketed logits within 1e-5 of the port's own exact-shape forward (v1-caffe
and v3; v3+'s bucketed output is approximate by design, so it is held within
1e-4 of the JAX package's bucketed output instead)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, _nhwc, random_jax_variables
from test_torch_seg_models import _rel, jax_tree_from_state_dict, port_key
from wseg_tpu.seg import backbones as jbb
from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu.seg.deeplab import PPM as JaxPPM
from wseg_tpu.seg.deeplab import generate_net as jax_generate_net
from wseg_tpu.seg.deeplab import seg_param_labels
from wseg_tpu.seg.xception import Xception as JaxXception
from wseg_tpu_torch.seg import backbones as tbb
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.seg.deeplab import PPM, generate_net
from wseg_tpu_torch.seg.xception import Xception
from wseg_tpu_torch.train.optim import seg_label_params
from wseg_tpu_torch.utils.checkpoint import seg_state_dict_from_jax

NETS = {
    "v1caffe_r18": dict(MODEL_NAME="deeplabv1_caffe", MODEL_BACKBONE="resnet18"),
    "v3_r18": dict(MODEL_NAME="deeplabv3", MODEL_BACKBONE="resnet18", MODEL_ASPP_OUTDIM=64,
                   MODEL_ASPP_HASGLOBAL=True),
    "v3plus_r18": dict(MODEL_NAME="deeplabv3plus", MODEL_BACKBONE="resnet18",
                       MODEL_ASPP_OUTDIM=64, MODEL_SHORTCUT_DIM=16),
    "v3plus_xception": dict(MODEL_NAME="deeplabv3plus", MODEL_BACKBONE="xception",
                            MODEL_ASPP_HASGLOBAL=True),
}


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX module, JAX variables, port module in eval mode)."""
    out = {}
    for i, (name, fields) in enumerate(NETS.items()):
        jmodel = jax_generate_net(JaxSegConfig(**fields))
        variables = random_jax_variables(jmodel, (1, 64, 64, 3), seed=40 + i)
        tmodel = generate_net(SegConfig(**fields), device="cpu").eval()
        tmodel.load_state_dict(seg_state_dict_from_jax(variables["params"],
                                                       variables["batch_stats"]), strict=True)
        out[name] = (jmodel, variables, tmodel)
    return out


def _load_backbone(net, jvars):
    sd = seg_state_dict_from_jax({"backbone": jvars["params"]},
                                 {"backbone": jvars["batch_stats"]})
    net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)


BACKBONES = {
    "resnet18_undilated": (lambda m: m.DilatedResNet(m.BasicBlock, (1, 1, 1, 1), dilated=False),
                           (4, 8, 16, 32)),
    "resnet50_7x7": (lambda m: m.DilatedResNet(m.Bottleneck, (1, 1, 1, 1), deep_base=False),
                     (4, 8, 8, 8)),
    "resnet50_7x7_undilated": (lambda m: m.DilatedResNet(m.Bottleneck, (1, 2, 1, 1),
                                                         dilated=False, deep_base=False),
                               (4, 8, 16, 32)),
    "xception_os8": (lambda m: (JaxXception if m is jbb else Xception)(os=8), (4, 8, 8)),
    "xception_os16": (lambda m: (JaxXception if m is jbb else Xception)(os=16), (4, 8, 16)),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_jax(name):
    """Every tap at 2 x 64 x 64, at the declared strides and widths, within
    1e-4 of the JAX package's largest entry: the ResNets in eval and train
    mode (batch statistics, with the running-mean updates); Xception at os
    8 in train mode with its running means (its eval mode is held through
    v3+ below); Xception at os 16 in eval mode, and in train mode for its l1
    and l2 taps. Its train-mode exit tap is held within 2e-4: ~60
    batch-statistics BNs, the last over 32 values a channel, carry the JAX
    formula's E[x^2] - E[x]^2 cancellation there, which puts JAX's tap
    1.12e-4 from a float64 forward and the port's 5.25e-5 (ROADMAP.md
    section 3), so the two may differ by their sum, 1.65e-4. The depthwise
    kernels cross through the HWIO -> OIHW transpose."""
    make, strides = BACKBONES[name]
    jnet, net = make(jbb), make(tbb)
    variables = random_jax_variables(jnet, (2, 64, 64, 3), seed=len(name))
    _load_backbone(net, variables)
    assert tuple(net.feature_strides) == tuple(jnet.feature_strides) == strides
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    checks = []  # (port taps, JAX taps, bound of each tap)
    with torch.no_grad():
        if name != "xception_os8":
            checks.append((net.eval()(_nchw(x)), jnet.apply(variables, jnp.asarray(x)),
                           (1e-4,) * len(strides)))
        want, new = jnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = net.train()(_nchw(x))
    checks.append((got, want, (1e-4, 1e-4, 2e-4) if name == "xception_os16"
                   else (1e-4,) * len(strides)))
    for got, ref, bounds in checks:
        assert len(got) == len(ref) == len(bounds)
        for g, w, s, c, bound in zip(got, ref, strides, net.feature_dims, bounds):
            assert g.shape == (2, c, 64 // s, 64 // s)
            assert _rel(_nhwc(g), np.asarray(w)) <= bound
    if name != "xception_os16":
        got_stats = {k: v for k, v in net.state_dict().items() if k.endswith("running_mean")}
        for path, w in jax.tree_util.tree_leaves_with_path(new["batch_stats"]):
            key = port_key(("backbone",) + tuple(k.key for k in path))[len("backbone."):]
            if key.endswith("running_mean"):
                old = np.asarray(_tree_get(variables["batch_stats"], path))
                d_want, d_got = np.asarray(w) - old, got_stats[key].numpy() - old
                assert np.abs(d_got - d_want).max() <= 1e-4 * np.abs(d_want).max(), key
    if name.startswith("xception"):
        dw = net.block4.sepconv1.depthwise
        assert dw.groups == 728 and dw.weight.shape == (728, 1, 3, 3)
        np.testing.assert_array_equal(
            dw.weight.detach().numpy()[:, 0],
            np.asarray(variables["params"]["block4"]["sepconv1"]["depthwise"]["kernel"])[
                :, :, 0].transpose(2, 0, 1))


def _tree_get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_ppm_matches_jax():
    """PPM (bins 1, 2, 3, 6) at 1 x 16 x 13 x 17 (h % b != 0: the pool is
    the reshape-mean over the top-left block), train mode: the 1-bin branch
    normalises one value per channel (the BN's n = 1 path). Output within
    1e-4 of its max, running means within 1e-4 of their update; then eval."""
    jppm = JaxPPM(8)
    variables = random_jax_variables(jppm, (1, 13, 17, 16), seed=3)
    ppm = PPM(16, 8)
    ppm.load_state_dict(seg_state_dict_from_jax(variables["params"], variables["batch_stats"]),
                        strict=True)
    x = np.abs(np.random.RandomState(5).randn(1, 13, 17, 16)).astype(np.float32)
    want, new = jppm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = ppm.train()(_nchw(x))
    assert got.shape == (1, 16 + 4 * 8, 13, 17)
    assert _rel(_nhwc(got), np.asarray(want)) <= 1e-4
    for i in range(4):
        w_new = np.asarray(new["batch_stats"][f"bin{i}"]["bn"]["mean"])
        w_old = np.asarray(variables["batch_stats"][f"bin{i}"]["bn"]["mean"])
        d_got = ppm.state_dict()[f"bin{i}.1.running_mean"].numpy() - w_old
        assert np.abs(d_got - (w_new - w_old)).max() <= 1e-4 * np.abs(w_new - w_old).max(), i
    with torch.no_grad():
        got_eval = ppm.eval()(_nchw(x))
    want_eval = jppm.apply({"params": variables["params"], "batch_stats": new["batch_stats"]},
                           jnp.asarray(x))
    assert _rel(_nhwc(got_eval), np.asarray(want_eval)) <= 1e-4


@pytest.mark.parametrize("name", list(NETS))
def test_net_eval_matches_jax(nets, name):
    """The raw logits (stride 8; stride 4 for v3+) and their align_corners=
    True upsample at 1 x 64 x 96 within 1e-4 of their max."""
    jmodel, variables, tmodel = nets[name]
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    fwd = jax.jit(lambda v, x, raw: jmodel.apply(v, x, raw_logits=raw), static_argnums=2)
    stride = 4 if "v3plus" in name else 8
    with torch.inference_mode():
        for raw in (True, False):
            want = np.asarray(fwd(variables, jnp.asarray(x), raw))
            got = _nhwc(tmodel(_nchw(x), raw_logits=raw))
            assert got.shape == want.shape == (
                (1, 64 // stride, 96 // stride, 21) if raw else (1, 64, 96, 21))
            assert _rel(got, want) <= 1e-4, raw


@pytest.mark.parametrize("name", list(NETS))
def test_net_bucketed_matches_jax(nets, name):
    """Two images of different sizes zero-padded into one 64 x 128 bucket
    with valid_hw: the valid logits within 1e-4 of the JAX package's
    bucketed forward; for v1-caffe and v3 also within 1e-5 of the port's own
    exact-shape forward of each image."""
    jmodel, variables, tmodel = nets[name]
    rng = np.random.RandomState(7)
    sizes = [(57, 89), (41, 70)]
    x = np.zeros((2, 64, 128, 3), np.float32)
    for i, (h, w) in enumerate(sizes):
        x[i, :h, :w] = rng.randn(h, w, 3)
    valid = np.array(sizes, np.int32)
    want = np.asarray(jax.jit(lambda v, x, m: jmodel.apply(v, x, valid_hw=m, raw_logits=True))(
        variables, jnp.asarray(x), jnp.asarray(valid)))
    with torch.inference_mode():
        got = _nhwc(tmodel(_nchw(x), valid_hw=torch.from_numpy(valid), raw_logits=True))
        assert _rel(got, want) <= 1e-4
        if "v3plus" in name:
            return
        for i, (h, w) in enumerate(sizes):
            exact = _nhwc(tmodel(_nchw(x[i:i + 1, :h, :w]), raw_logits=True))[0]
            h8, w8 = exact.shape[:2]
            assert (h8, w8) == (-(-h // 8), -(-w // 8))
            assert np.abs(got[i, :h8, :w8] - exact).max() <= 1e-5 * np.abs(exact).max(), i


@pytest.mark.parametrize("name", list(NETS))
def test_seg_param_labels_match_jax(nets, name):
    """Key for key against the JAX package's seg_param_labels with the
    net's FROM_SCRATCH, as its seg_train passes it: v1-caffe's conv_fov and
    conv_fov2 are pretrained, only cls_conv is scratch; Xception's BNs
    (bn1 / bn2 / skipbn) are frozen."""
    jmodel, variables, tmodel = nets[name]
    scratch = getattr(type(jmodel), "FROM_SCRATCH", None)
    want = {port_key(tuple(k.key for k in path)): v for path, v in
            jax.tree_util.tree_leaves_with_path(seg_param_labels(variables["params"], scratch))}
    got = seg_label_params(tmodel)
    assert got == want
    assert got["cls_conv.weight"] == "scratch_w"
    if name == "v1caffe_r18":
        assert got["conv_fov.weight"] == got["conv_fov2.weight"] == "pretrained_w"
        assert got["conv_fov.bias"] == "pretrained_b"
        assert seg_label_params(tmodel, scratch_mods=("cls_conv", "conv_fov"))[
            "conv_fov.weight"] == "scratch_w"
    if name == "v3plus_xception":
        assert got["backbone.block5.sepconv2.bn1.weight"] == "frozen"
        assert got["backbone.block1.skipbn.bias"] == "frozen"
        assert got["shortcut_conv.0.weight"] == "scratch_w"


def test_seg_bridge_round_trips_every_net(nets):
    """JAX tree -> port state_dict -> JAX tree is the identity, bit for bit,
    for each new net."""
    for name, (_, variables, tmodel) in nets.items():
        back = jax_tree_from_state_dict(tmodel.state_dict(), variables)
        for c in ("params", "batch_stats"):
            la = jax.tree_util.tree_leaves_with_path(back[c])
            lb = jax.tree_util.tree_leaves_with_path(variables[c])
            assert [p for p, _ in la] == [p for p, _ in lb], name
            for (p, a), (_, b) in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
