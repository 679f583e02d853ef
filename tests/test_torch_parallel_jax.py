"""The data-parallel stage-3 step of the port against the JAX package's: two
train-mode DeepLab v2 steps (resnet18, ASPP with its global branch, batch 4:
tests/test_torch_seg_train_aspp.py's setup) on 2 gloo ranks against
`wseg_tpu.train.seg.make_seg_train_step` jitted with the batch sharded over
a 2-device virtual mesh, from the same weights (`seg_state_dict_from_jax`).
Both dropouts keep everything, as in that test. The four samples ignore
5%, 10%, 40% and 60% of their pixels, so the ranks' valid counts differ.
The tolerances are tests/test_torch_seg_train.py's: loss within 1e-6
relative, parameters within 1e-4 of their largest entry, running-stat
updates within 1e-4 of theirs plus one float32 ulp of the stat."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_models import _nchw, random_jax_variables
from test_torch_seg_train import LR, MAX_ITR, WD, check_loss, check_params, check_running_stats
from wseg_tpu.parallel.mesh import make_mesh
from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu.seg.deeplab import generate_net as jax_generate_net
from wseg_tpu.seg.deeplab import seg_param_labels
from wseg_tpu.train.optim import poly_sgd
from wseg_tpu.train.seg import SegTrainState
from wseg_tpu.train.seg import make_seg_train_step as jax_make_seg_train_step
from wseg_tpu_torch.parallel.launch import spawn
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.seg.deeplab import generate_net
from wseg_tpu_torch.train.optim import seg_label_params
from wseg_tpu_torch.utils.checkpoint import seg_state_dict_from_jax

TESTS = os.path.dirname(os.path.abspath(__file__))
NET = dict(MODEL_NAME="deeplabv2", MODEL_BACKBONE="resnet18", MODEL_ASPP_OUTDIM=64,
           MODEL_ASPP_HASGLOBAL=True)


def _jax_mesh_steps(jmodel, params, stats, data):
    """The JAX package's step on a 2-device mesh: state replicated, the batch
    sharded, every dropout keeping all."""
    mesh = make_mesh(jax.devices()[:2])
    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    tx = poly_sgd(LR, WD, max_step=MAX_ITR + 1, momentum=0.9,
                  labels=seg_param_labels(params, getattr(type(jmodel), "FROM_SCRATCH", None)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.ones(shape if shape is not None else (),
                                                           bool))
        jstep = jax_make_seg_train_step(jmodel, tx)
        state = jax.device_put(
            SegTrainState(jax.tree_util.tree_map(jnp.array, params), tx.init(params),
                          jax.tree_util.tree_map(jnp.array, stats), jax.random.PRNGKey(5)), repl)
        ref = []
        for x, lab in data:
            state, mets = jstep(state, jax.device_put(jnp.asarray(x), rows),
                                jax.device_put(jnp.asarray(lab), rows))
            ref.append((float(mets["loss"]), jax.device_get(state.params),
                        jax.device_get(state.batch_stats)))
    return ref


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seg_dp")
    rng = np.random.RandomState(32)
    data = []
    for _ in range(2):
        x = rng.randn(4, 48, 64, 3).astype(np.float32)
        lab = rng.randint(0, 21, size=(4, 48, 64)).astype(np.int32)
        lab[rng.rand(4, 48, 64) < np.array([0.05, 0.1, 0.4, 0.6])[:, None, None]] = 255
        data.append((x, lab))

    jmodel = jax_generate_net(JaxSegConfig(**NET))
    variables = random_jax_variables(jmodel, (1, 48, 64, 3), seed=8)
    # a start near ln(21), as tests/test_torch_seg_train.py's run_two_steps
    variables["params"]["cls_conv"]["kernel"] = variables["params"]["cls_conv"]["kernel"] * 0.02
    params, stats = variables["params"], variables["batch_stats"]
    weights = str(tmp / "w.pth")
    torch.save(seg_state_dict_from_jax(params, stats), weights)
    port = spawn("torch_dp_workers:seg_steps", 2, tmp / "ranks",
                 dict(cfg_kw=NET, weights=weights, lr=LR, wd=WD, max_itr=MAX_ITR,
                      batches=[(_nchw(x).numpy(), lab) for x, lab in data]),
                 timeout=300.0, pythonpath=[TESTS])
    ref = _jax_mesh_steps(jmodel, params, stats, data)
    assert [s[0] for s in port[0]] == [s[0] for s in port[1]]  # one global loss
    labels = seg_label_params(generate_net(SegConfig(**NET), device="cpu"))
    return dict(port=port[0], ref=ref, params=params, stats=stats, labels=labels)


@pytest.mark.parametrize("i", [0, 1])
def test_dp_seg_step_loss_matches_jax_mesh(dp_steps, i):
    check_loss(dp_steps, i)


@pytest.mark.parametrize("i", [0, 1])
def test_dp_seg_step_params_match_jax_mesh(dp_steps, i):
    check_params(dp_steps, i)


@pytest.mark.parametrize("i", [0, 1])
def test_dp_seg_step_running_stats_match_jax_mesh(dp_steps, i):
    """Every BN's stats, the global branch's `aspp.branch5_bn` (two values a
    channel on each rank, four over the group) among them."""
    keys = [k for k in dp_steps["port"][i][1] if k.endswith("running_mean")]
    assert "aspp.branch5_bn.running_mean" in keys
    assert check_running_stats(dp_steps, i) == 2 * len(keys)
