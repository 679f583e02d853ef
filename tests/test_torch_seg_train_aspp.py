"""Two train-mode DeepLab v2 steps of the port against the JAX package's
(`jax.value_and_grad` + `poly_sgd`), on the CPU in float32: ASPP with its
global branch (batch-statistics BN on the pooled (N, C, 1, 1) features) and
both of v2's dropouts (ASPP's output, and before cls_conv:
wseg_tpu/seg/deeplab.py:84-88, 235-238), on a resnet18 backbone at batch 4.
The tolerances are tests/test_torch_seg_train.py's: loss within 1e-6
relative, parameters within 1e-4 of their largest entry, running-stat
updates within 1e-4 of theirs plus one float32 ulp of the stat."""

import pytest

from test_torch_seg_train import check_loss, check_params, check_running_stats, run_two_steps
from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu_torch.seg.config import SegConfig

NET = dict(MODEL_NAME="deeplabv2", MODEL_BACKBONE="resnet18", MODEL_ASPP_OUTDIM=64,
           MODEL_ASPP_HASGLOBAL=True)


@pytest.fixture(scope="module")
def v2_steps():
    return run_two_steps(JaxSegConfig(**NET), SegConfig(**NET), batch=4, seed=8)


@pytest.mark.parametrize("i", [0, 1])
def test_v2_aspp_step_loss_matches_jax(v2_steps, i):
    check_loss(v2_steps, i)


@pytest.mark.parametrize("i", [0, 1])
def test_v2_aspp_step_params_match_jax(v2_steps, i):
    check_params(v2_steps, i)
    assert v2_steps["labels"]["aspp.branch5_conv.weight"] != "frozen"


@pytest.mark.parametrize("i", [0, 1])
def test_v2_aspp_step_running_stats_match_jax(v2_steps, i):
    """Every BN's stats, the global branch's `aspp.branch5_bn` among them."""
    keys = [k for k in v2_steps["port"][i][1] if k.endswith("running_mean")]
    assert "aspp.branch5_bn.running_mean" in keys
    assert check_running_stats(v2_steps, i) == 2 * len(keys)
