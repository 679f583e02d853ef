"""Train-mode steps of the new DeepLab heads against the JAX package's
(`jax.value_and_grad` + `poly_sgd` with seg_param_labels and the net's
FROM_SCRATCH), on the CPU in float32, each on a resnet18 backbone at batch 4
with every dropout keeping all units: v1-caffe (the -inf-halo max pool, the
4096-wide biased head, its pretrained-group conv_fov / conv_fov2) and v3+
(v3's ASPP with the 1x1 rate-0 branch, then the low-level shortcut and
cat_convs at stride 4; v3's own head is that ASPP and cls_conv, held in
eval mode by tests/test_torch_seg_nets.py). The tolerances are
tests/test_torch_seg_train.py's: loss within 1e-6 relative, parameters
within 1e-4 of their largest entry, running-stat updates within 1e-4 of
theirs plus one float32 ulp of the stat."""

import pytest

from test_torch_seg_train import check_loss, check_params, check_running_stats, run_two_steps
from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu_torch.seg.config import SegConfig

NETS = {
    "v1caffe": dict(MODEL_NAME="deeplabv1_caffe", MODEL_BACKBONE="resnet18"),
    "v3plus": dict(MODEL_NAME="deeplabv3plus", MODEL_BACKBONE="resnet18", MODEL_ASPP_OUTDIM=64,
                   MODEL_SHORTCUT_DIM=16, MODEL_ASPP_HASGLOBAL=True),
}
_RUNS = {}


def steps_of(name):
    if name not in _RUNS:
        fields = NETS[name]
        _RUNS[name] = run_two_steps(JaxSegConfig(**fields), SegConfig(**fields), batch=4, seed=9)
    return _RUNS[name]


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("name", list(NETS))
def test_head_step_matches_jax(name, i):
    """Step i's loss, parameters (the trained ones moved, BN affine did
    not, on both sides) and every BN's running-stat update."""
    steps = steps_of(name)
    check_loss(steps, i)
    check_params(steps, i)
    assert check_running_stats(steps, i) > 0
    labels = steps["labels"]
    if name == "v1caffe":
        assert labels["conv_fov.weight"] == "pretrained_w"
        assert labels["cls_conv.bias"] == "scratch_b"
    if name == "v3plus":
        assert labels["shortcut_conv.0.weight"] == labels["cat_conv2.0.weight"] == "scratch_w"
        assert labels["aspp.branch1.0.weight"] == "scratch_w"
