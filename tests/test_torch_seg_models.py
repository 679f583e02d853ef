"""The port's stage-3 nets against the JAX package's with the same weights:
batch-statistics BN, DeepLab v1 on ResNet-38 and v2 on the dilated ResNets
(eval forwards, exact and bucketed), the stage-3 parameter labels and the
seg weight bridge. Weights are numpy-seeded JAX trees (He-normal kernels,
random BN) carried across with `seg_state_dict_from_jax`; f32 on the CPU;
each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, _nhwc, random_jax_variables
from wseg_tpu.models.layers import BatchNorm2d as JaxBatchNorm2d
from wseg_tpu.seg.config import EXPERIMENTS as JAX_EXPERIMENTS
from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu.seg.deeplab import generate_net as jax_generate_net
from wseg_tpu.seg.deeplab import seg_param_labels
from wseg_tpu.utils.checkpoint import save_checkpoint
from wseg_tpu_torch.models.layers import BatchNorm2d
from wseg_tpu_torch.seg.config import EXPERIMENTS, SegConfig
from wseg_tpu_torch.seg.deeplab import generate_net
from wseg_tpu_torch.train.optim import seg_label_params
from wseg_tpu_torch.utils.checkpoint import (
    _seg_module_key, load_weights, seg_state_dict_from_jax,
)

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}

# (name, config fields): the SEAM preset and DeepLab v2 with the global ASPP
# branch on a BasicBlock and a Bottleneck ResNet (resnet101's code at a
# CPU-sized depth)
NETS = {
    "v1_r38": {},
    "v2_r18": dict(MODEL_NAME="deeplabv2", MODEL_BACKBONE="resnet18", MODEL_ASPP_HASGLOBAL=True),
    "v2_r50": dict(MODEL_NAME="deeplabv2", MODEL_BACKBONE="resnet50", MODEL_ASPP_HASGLOBAL=True),
}


def port_key(path) -> str:
    return _seg_module_key(path) + "." + _LEAF[path[-1]]


def jax_tree_from_state_dict(sd, like):
    """The inverse bridge, for the tests: a port state_dict -> (params,
    batch_stats) trees shaped like `like`'s."""
    def get(path, leaf):
        t = sd[port_key(tuple(k.key for k in path))].numpy()
        return t.transpose(2, 3, 1, 0) if t.ndim == 4 else t

    return {c: jax.tree_util.tree_map_with_path(get, like[c])
            for c in ("params", "batch_stats")}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX module, JAX variables, port module in eval mode)."""
    out = {}
    for i, (name, fields) in enumerate(NETS.items()):
        jmodel = jax_generate_net(JaxSegConfig(**fields))
        variables = random_jax_variables(jmodel, (1, 64, 64, 3), seed=20 + i)
        tmodel = generate_net(SegConfig(**fields), device="cpu").eval()
        tmodel.load_state_dict(seg_state_dict_from_jax(variables["params"],
                                                       variables["batch_stats"]), strict=True)
        out[name] = (jmodel, variables, tmodel)
    return out


def _bn_case(seed, shift, momentum, c=24):
    """An NHWC input of per-channel mean ~ N(0, shift) and std 1.7, random
    affine and running stats; the JAX BN's train-mode output and new stats,
    and the port's BN loaded with the same values."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 9, 11, c) * 1.7 + rng.randn(c) * shift).astype(np.float32)
    weight, bias = rng.normal(1, .2, c).astype(np.float32), rng.normal(0, .2, c).astype(np.float32)
    mean, var = rng.normal(0, .5, c).astype(np.float32), rng.uniform(.5, 2, c).astype(np.float32)
    jbn = JaxBatchNorm2d(c, momentum=momentum, frozen=False)
    jvars = {"params": {"scale": weight, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    want, new = jbn.apply(jvars, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    bn = BatchNorm2d(c, frozen=False, momentum=momentum)
    bn.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    return x, jbn, jvars, np.asarray(want), new["batch_stats"], bn


@pytest.mark.parametrize("momentum", [0.1, 3e-4])
def test_batch_stats_bn_matches_jax(momentum):
    """Train mode: the output within 1e-6 of its max and the running-stat
    update (new - old) within 1e-5 of its max; then eval mode on the
    updated stats within 1e-6."""
    x, jbn, jvars, want, new, bn = _bn_case(int(momentum * 1e4) + 5, 0.5, momentum)
    got = bn.train()(_nchw(x))
    assert _rel(_nhwc(got), want) <= 1e-6
    for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
        old = jvars["batch_stats"][leaf]
        want_d = np.asarray(new[leaf]) - old
        got_d = bn.state_dict()[key].numpy() - old
        assert np.abs(want_d).max() > 0
        assert _rel(got_d, want_d) <= 1e-5, leaf

    want_eval = jbn.apply({"params": jvars["params"], "batch_stats": new}, jnp.asarray(x),
                          use_running_average=True)
    with torch.no_grad():
        got_eval = bn.eval()(_nchw(x))
    assert _rel(_nhwc(got_eval), np.asarray(want_eval)) <= 1e-6


def test_batch_stats_bn_is_exact_where_the_jax_formula_loses_digits():
    """At a per-channel mean of ~2 std, the JAX package's E[x^2] - E[x]^2
    loses digits to cancellation: its output is ~1e-6 of its max from the
    float64 result. The port's (F.batch_norm) is within 2e-7."""
    x, _, jvars, want, _, bn = _bn_case(1000, 2.0, 0.1)
    x64 = x.astype(np.float64)
    w, b = jvars["params"]["scale"], jvars["params"]["bias"]
    exact = (x64 - x64.mean((0, 1, 2))) / np.sqrt(x64.var((0, 1, 2)) + 1e-5) * w + b
    got = _nhwc(bn.train()(_nchw(x)))
    assert _rel(got, exact) <= 2e-7
    assert _rel(want, exact) > 5e-7


def test_frozen_bn_ignores_train_mode():
    """The default (stages 1-2) normalises with the running stats in train
    mode too, and never moves them."""
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
    x = torch.randn(2, 3, 4, 5)
    torch.testing.assert_close(bn.train()(x), bn.eval()(x), rtol=0, atol=0)
    assert bn.running_mean.tolist() == [0.5, -1.0, 2.0]


@pytest.mark.parametrize("name", list(NETS))
def test_seg_net_eval_matches_jax(nets, name):
    """The stride-8 logits and their align_corners=True upsample at 1 x 64 x
    96 within 1e-4 of their max."""
    jmodel, variables, tmodel = nets[name]
    x = np.random.RandomState(5).randn(1, 64, 96, 3).astype(np.float32)
    fwd = jax.jit(lambda v, x, raw: jmodel.apply(v, x, raw_logits=raw), static_argnums=2)
    with torch.inference_mode():
        for raw in (True, False):
            want = np.asarray(fwd(variables, jnp.asarray(x), raw))
            got = _nhwc(tmodel(_nchw(x), raw_logits=raw))
            assert got.shape == want.shape == ((1, 8, 12, 21) if raw else (1, 64, 96, 21))
            assert _rel(got, want) <= 1e-4, raw


@pytest.mark.parametrize("name", ["v1_r38", "v2_r18"])
def test_seg_net_bucketed_matches_jax_and_exact(nets, name):
    """Two images of different sizes zero-padded into one 64-bucket with
    valid_hw: the port's valid stride-8 logits within 1e-5 of the max of its
    own exact-shape forward of each image, and within 1e-4 of the JAX
    package's bucketed forward."""
    jmodel, variables, tmodel = nets[name]
    rng = np.random.RandomState(6)
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
        for i, (h, w) in enumerate(sizes):
            exact = _nhwc(tmodel(_nchw(x[i:i + 1, :h, :w]), raw_logits=True))[0]
            h8, w8 = exact.shape[:2]
            assert (h8, w8) == (-(-h // 8), -(-w // 8))
            assert np.abs(got[i, :h8, :w8] - exact).max() <= 1e-5 * np.abs(exact).max(), i


@pytest.mark.parametrize("name", ["v1_r38", "v2_r18"])
def test_seg_param_labels_match_jax(nets, name):
    """Key for key: frozen BN affine (including downsample.1, conv1.1 and the
    ASPP Sequentials' BNs), pretrained backbone convs (conv1a and b2*
    included), scratch head convs."""
    _, variables, tmodel = nets[name]
    want = {port_key(tuple(k.key for k in path)): v for path, v in
            jax.tree_util.tree_leaves_with_path(seg_param_labels(variables["params"]))}
    got = seg_label_params(tmodel)
    assert got == want
    assert got["backbone.conv1a.weight" if name == "v1_r38" else "backbone.conv1.0.weight"] \
        == "pretrained_w"
    assert got["cls_conv.bias"] == "scratch_b"


def test_seg_bridge_round_trip_and_ckpt(nets, tmp_path):
    """JAX tree -> port state_dict -> JAX tree is the identity, bit for bit,
    for each net; a JAX `.ckpt` of the v2 net loads through load_weights(seg
    =True) to the same state_dict."""
    for name, (_, variables, tmodel) in nets.items():
        back = jax_tree_from_state_dict(tmodel.state_dict(), variables)
        for c in ("params", "batch_stats"):
            la = jax.tree_util.tree_leaves_with_path(back[c])
            lb = jax.tree_util.tree_leaves_with_path(variables[c])
            assert [p for p, _ in la] == [p for p, _ in lb], name
            for (p, a), (_, b) in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    _, variables, tmodel = nets["v2_r18"]
    path = str(tmp_path / "seg.ckpt")
    save_checkpoint(path, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    sd = load_weights(path, seg=True)
    want = tmodel.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("bad", [
    ("aspp", "branch9", "conv", "kernel"), ("backbone", "layer5_0", "conv1", "kernel"),
    ("backbone", "layer1_0", "conv4", "kernel"), ("head", "kernel"), ("b2", "conv_branch2a",
                                                                      "kernel"),
])
def test_seg_bridge_raises_on_unknown_key(bad):
    """An entry the bridge cannot place raises, naming it: an unknown ASPP
    branch, layer or block module, a top-level name, or a stage-1 tree."""
    tree = {}
    node = tree
    for k in bad[:-1]:
        node = node.setdefault(k, {})
    node[bad[-1]] = np.zeros((1, 1, 2, 2), np.float32)
    with pytest.raises(KeyError, match="/".join(bad)):
        seg_state_dict_from_jax(tree, {})


def test_presets_match_jax():
    """The three presets are field-for-field the JAX package's."""
    assert EXPERIMENTS.keys() == JAX_EXPERIMENTS.keys()
    for name in EXPERIMENTS:
        assert vars(EXPERIMENTS[name]) == vars(JAX_EXPERIMENTS[name]), name
    assert EXPERIMENTS["EPS_deeplabv2_resnet101"].MODEL_ASPP_HASGLOBAL


def test_resnet38_backbone_ignores_bn_mom():
    """Every trunk BN, bn7 included, keeps momentum 3e-4 whatever
    TRAIN_BN_MOM says; the head's BNs take TRAIN_BN_MOM; b6/b7 dropout is
    live in train mode."""
    model = generate_net(EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(TRAIN_BN_MOM=0.1),
                         device="cpu")
    trunk = [m for n, m in model.named_modules()
             if isinstance(m, BatchNorm2d) and n.startswith("backbone.")]
    assert len(trunk) == 37 and all(m.momentum == 3e-4 and not m.frozen for m in trunk)
    assert model.bn_fov.momentum == model.bn_fov2.momentum == 0.1
    assert model.backbone.b7.dropout_2b2.rate == 0.5 and model.backbone.b6.dropout_2b1.rate == 0.3


def test_multi_grid_backbone_matches_jax():
    """DilatedResNet with multi-grid (layer4's blocks at dilations 3, 4, 5,
    backbones.py:156-177) on BasicBlocks, every tap against the JAX
    package's at 1 x 40 x 56 in train mode: within 1e-4 of each tap's max."""
    from wseg_tpu.seg.backbones import BasicBlock as JaxBasicBlock
    from wseg_tpu.seg.backbones import DilatedResNet as JaxDilatedResNet
    from wseg_tpu_torch.seg.backbones import BasicBlock, DilatedResNet

    jnet = JaxDilatedResNet(JaxBasicBlock, (1, 1, 1, 3), multi_grid=True)
    variables = random_jax_variables(jnet, (2, 40, 56, 3), seed=9)
    net = DilatedResNet(BasicBlock, (1, 1, 1, 3), multi_grid=True)
    sd = seg_state_dict_from_jax({"backbone": variables["params"]},
                                 {"backbone": variables["batch_stats"]})
    net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    assert [b.conv1.dilation[0] for b in net.layer4] == [3, 4, 5]
    x = np.random.RandomState(3).randn(2, 40, 56, 3).astype(np.float32)
    want, _ = jnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = net.train()(_nchw(x))
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), np.asarray(w)) <= 1e-4


@pytest.mark.parametrize("exp", list(EXPERIMENTS))
def test_every_preset_builds_and_trains_a_step(exp):
    """Each preset's net (v1 / ResNet-38, v1 / ResNet-101, v2 / ResNet-101
    with the global ASPP branch) at full width: a train-mode forward of 2 x
    32 x 40 gives upsampled logits, and its eval-mode raw logits are at
    stride 8."""
    model = generate_net(EXPERIMENTS[exp], device="cpu")
    x = torch.randn(2, 3, 32, 40, generator=torch.Generator().manual_seed(1))
    out = model.train()(x)
    assert out.shape == (2, 21, 32, 40) and bool(torch.isfinite(out).all())
    out.mean().backward()
    with torch.no_grad():
        assert model.eval()(x, raw_logits=True).shape == (2, 21, 4, 5)
