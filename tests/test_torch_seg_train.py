"""The port's stage-3 training against the JAX package's, on the CPU in
float32: the ignore-255 cross-entropy, the head's element-wise dropout, and
two full-width DeepLab v1 / ResNet-38 train-mode steps against the JAX
package's jitted step (`jax.value_and_grad` + `poly_sgd` with the seg labels
and momentum 0.9). Dropout keeps everything on both sides, scaled as a kept
unit is (the JAX side's `jax.random.bernoulli` patched to all-True, as
tests/test_seg_reference_oracle.py does). Inputs are numpy-seeded; weights
cross with `seg_state_dict_from_jax`; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, random_jax_variables
from test_torch_seg_models import port_key
from wseg_tpu.seg.config import EXPERIMENTS as JAX_EXPERIMENTS
from wseg_tpu.seg.deeplab import generate_net as jax_generate_net
from wseg_tpu.seg.deeplab import seg_param_labels
from wseg_tpu.train.optim import poly_sgd
from wseg_tpu.train.seg import SegTrainState
from wseg_tpu.train.seg import cross_entropy_ignore as jax_cross_entropy_ignore
from wseg_tpu.train.seg import make_seg_train_step as jax_make_seg_train_step
from wseg_tpu_torch.models.layers import Dropout
from wseg_tpu_torch.seg.config import EXPERIMENTS
from wseg_tpu_torch.seg.deeplab import generate_net
from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
from wseg_tpu_torch.train.seg import cross_entropy_ignore, make_seg_train_step
from wseg_tpu_torch.utils.checkpoint import seg_state_dict_from_jax

LR, WD, MAX_ITR = 1e-3, 5e-4, 10


@pytest.mark.parametrize("ignored", [0.1, 1.0])
def test_cross_entropy_ignore_matches_jax(ignored):
    """Mean NLL over the labels that are not 255 within 1e-6 relative; 0,
    not NaN, when every label is ignored."""
    rng = np.random.RandomState(int(ignored * 10))
    logits = rng.randn(2, 21, 9, 13).astype(np.float32) * 3
    labels = rng.randint(0, 21, (2, 9, 13))
    labels[rng.rand(*labels.shape) < ignored] = 255
    want = float(jax_cross_entropy_ignore(logits.transpose(0, 2, 3, 1), labels))
    got = float(cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)
    if ignored == 1.0:
        assert got == want == 0.0


def test_elementwise_dropout_draws_from_the_generator():
    """Train mode keeps each element with probability 0.5 and scales the kept
    by 2; the draw is the generator's (same seed, same mask); eval mode and
    rate 0 are the identity."""
    drop = Dropout(0.5).train()
    x = torch.rand(4, 8, 16, 16) + 0.5
    masks = []
    for _ in range(2):
        drop.generator = torch.Generator().manual_seed(3)
        y = drop(x)
        kept = y != 0
        torch.testing.assert_close(y[kept], 2 * x[kept], rtol=0, atol=0)
        masks.append(kept)
    assert torch.equal(masks[0], masks[1])
    assert abs(masks[0].float().mean().item() - 0.5) < 0.02
    drop.generator = torch.Generator().manual_seed(4)
    assert not torch.equal(drop(x) != 0, masks[0])
    assert torch.equal(drop.eval()(x), x)
    drop.rate = 0.0
    assert torch.equal(drop.train()(x), x)


def _keep_all(model):
    """Every dropout keeps every unit, scaled by 1 / (1 - rate), as the JAX
    side's with `jax.random.bernoulli` all-True."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.forward = (lambda x, s=1.0 / (1.0 - m.rate): x * s)


def run_two_steps(jax_cfg, port_cfg, batch: int, seed: int = 7):
    """Two steps of each package from the same weights, `batch` images at
    48x64, labels 0..20 with ~10% 255. Returns per-step (loss, params,
    stats) of both and the initial trees."""
    rng = np.random.RandomState(31)
    data = []
    for _ in range(2):
        x = rng.randn(batch, 48, 64, 3).astype(np.float32)
        lab = rng.randint(0, 21, size=(batch, 48, 64)).astype(np.int32)
        lab[rng.rand(*lab.shape) < 0.1] = 255
        data.append((x, lab))

    jmodel = jax_generate_net(jax_cfg)
    variables = random_jax_variables(jmodel, (1, 48, 64, 3), seed=seed)
    # a raw He-init cls_conv on 512 channels starts at CE ~ 13 where a step
    # amplifies rounding; scaled, the start is near ln(21) (the oracle's
    # contractive regime, test_seg_reference_oracle.py:602-611)
    variables["params"]["cls_conv"]["kernel"] = variables["params"]["cls_conv"]["kernel"] * 0.02
    params, stats = variables["params"], variables["batch_stats"]

    tmodel = generate_net(port_cfg, device="cpu")
    tmodel.load_state_dict(seg_state_dict_from_jax(params, stats), strict=True)
    _keep_all(tmodel)
    opt = PolySGD(param_groups(tmodel, seg_label_params(tmodel)), LR, WD, MAX_ITR + 1,
                  momentum=0.9)
    step = make_seg_train_step(tmodel, opt)
    port = []
    for x, lab in data:
        mets = step(_nchw(x), torch.from_numpy(lab))
        port.append((float(mets["loss"]),
                     {k: v.detach().clone() for k, v in tmodel.state_dict().items()}))

    tx = poly_sgd(LR, WD, max_step=MAX_ITR + 1, momentum=0.9,
                  labels=seg_param_labels(params, getattr(type(jmodel), "FROM_SCRATCH", None)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.ones(shape if shape is not None else (),
                                                           bool))
        jstep = jax_make_seg_train_step(jmodel, tx)
        state = SegTrainState(jax.tree_util.tree_map(jnp.array, params), tx.init(params),
                              jax.tree_util.tree_map(jnp.array, stats), jax.random.PRNGKey(5))
        ref = []
        for x, lab in data:
            state, mets = jstep(state, jnp.asarray(x), jnp.asarray(lab))
            ref.append((float(mets["loss"]), jax.device_get(state.params),
                        jax.device_get(state.batch_stats)))
    return dict(port=port, ref=ref, params=params, stats=stats, labels=seg_label_params(tmodel))


@pytest.fixture(scope="module")
def two_steps():
    """DeepLab v1 / ResNet-38 at batch 2."""
    return run_two_steps(JAX_EXPERIMENTS["SEAM_deeplabv1_resnet38"],
                         EXPERIMENTS["SEAM_deeplabv1_resnet38"], batch=2)


def _leaves(tree):
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        yield port_key(tuple(k.key for k in path)), np.asarray(v)


def _port_array(t):
    t = t.numpy()
    return t.transpose(2, 3, 1, 0) if t.ndim == 4 else t


def check_loss(steps, i):
    got, want = steps["port"][i][0], steps["ref"][i][0]
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def check_params(steps, i):
    """Every parameter within 1e-4 of its largest entry of the JAX
    package's; the trained ones moved and BN affine did not, on both sides."""
    sd = steps["port"][i][1]
    init = dict(_leaves(steps["params"]))
    moved = 0
    for key, want in _leaves(steps["ref"][i][1]):
        got = _port_array(sd[key])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), key
        if steps["labels"][key] == "frozen":
            np.testing.assert_array_equal(got, init[key])
            np.testing.assert_array_equal(want, init[key])
        else:
            moved += bool(np.abs(got - init[key]).max() > 0)
    assert moved == sum(v != "frozen" for v in steps["labels"].values())


def check_running_stats(steps, i) -> int:
    """Each BN's running-stat update within 1e-4 of its largest entry plus
    one float32 ulp of the stored value; returns the count of stats held."""
    sd = steps["port"][i][1]
    old_port = (dict(_leaves(steps["stats"])) if i == 0 else
                {k: _port_array(v) for k, v in steps["port"][0][1].items()})
    old_ref = dict(_leaves(steps["stats"] if i == 0 else steps["ref"][0][2]))
    n = 0
    for key, want in _leaves(steps["ref"][i][2]):
        got_d, want_d = _port_array(sd[key]) - old_port[key], want - old_ref[key]
        assert np.abs(want_d).max() > 0, key
        ulp = np.spacing(np.abs(want).max())
        assert np.abs(got_d - want_d).max() <= 1e-4 * np.abs(want_d).max() + ulp, key
        n += 1
    return n


@pytest.mark.parametrize("i", [0, 1])
def test_seg_train_step_loss_matches_jax(two_steps, i):
    """Step i's loss within 1e-6 relative (step 1 runs on step 0's weights,
    momentum and running stats)."""
    check_loss(two_steps, i)


@pytest.mark.parametrize("i", [0, 1])
def test_seg_train_step_params_match_jax(two_steps, i):
    """After step i, every parameter within 1e-4 of its largest entry of the
    JAX package's; the trained ones moved (conv1a and b2* included) and BN
    affine did not, on both sides."""
    check_params(two_steps, i)
    for key in ("backbone.conv1a.weight", "backbone.b2.conv_branch2a.weight"):
        assert two_steps["labels"][key] == "pretrained_w"


@pytest.mark.parametrize("i", [0, 1])
def test_seg_train_step_running_stats_match_jax(two_steps, i):
    """The running-stat update of step i, new - old, within 1e-4 of its
    largest entry plus one float32 ulp of the stored value, for every BN: the
    trunk's at momentum 3e-4, the head's at TRAIN_BN_MOM (3e-4 in the
    preset). The ulp is the storage's: at momentum 3e-4 an update is ~3e-4
    of a stat of magnitude ~1, so rounding the new value to float32 alone
    moves the update by up to ~4e-4 of itself (ROADMAP.md section 3)."""
    assert check_running_stats(two_steps, i) == 2 * 39


def test_resize_weights_cached_in_inference_mode_train():
    """A resize first run under torch.inference_mode() (seg_test's forward)
    caches its matrices; a training step at the same sizes reuses them and
    backpropagates through them (the stride-8 logits' upsample)."""
    from wseg_tpu_torch.ops.resize import resize_bilinear

    with torch.inference_mode():
        resize_bilinear(torch.randn(1, 21, 7, 11), (53, 83), align_corners=True)
    x = torch.randn(2, 21, 7, 11, requires_grad=True)
    resize_bilinear(x, (53, 83), align_corners=True).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
