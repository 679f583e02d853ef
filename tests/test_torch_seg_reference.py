"""The port's stage-3 step against the benchmark's plain reference
(benchmark/reference/deeplab.py), on the CPU in float64: DeepLab v1 /
ResNet-38 at full widths on 2 x 32 x 40 crops, built by `build_seg_trainer`
from the SEAM preset, on seeded random weights, over two steps with the
channel and element-wise dropouts on (both sides draw from one seed in one
order). Compared: each step's loss, every trained leaf's gradient at step
1, and after step 2 every BN running statistic and every parameter.

Float64, because at this size float32 rounding is amplified: on some
batches the early layers' gradients of two float32 runs that differ only
in rounding part by ~2e-3 (within 1.2e-7 in float64). The loss itself is
float32 in the port (`cross_entropy_ignore` upcasts to it), which bounds
the agreement at ~1e-7."""

import pytest
import torch

from benchmark import weights
from benchmark.reference import deeplab
from wseg_tpu_torch.seg.config import EXPERIMENTS
from wseg_tpu_torch.train.seg import build_seg_trainer

SEED = 20260
N, H, W = 2, 32, 40
CFG = {"lr": 1e-3, "weight_decay": 5e-4, "momentum": 0.9, "poly_power": 0.9,
       "max_itr": 20000, "bn_mom": 3e-4}


def _batches():
    g = torch.Generator().manual_seed(SEED + 1)
    out = []
    for _ in range(2):
        img = torch.randn(N, H, W, 3, generator=g, dtype=torch.float64).permute(0, 3, 1, 2)
        label = torch.randint(0, 21, (N, H, W), generator=g, dtype=torch.int32)
        label[:, :, 30:] = 255  # a crop's pad
        out.append((img, label))
    return out


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.fixture(scope="module")
def runs():
    p0 = weights.make(deeplab.param_specs(), torch.Generator().manual_seed(SEED), "cpu")
    p0 = {k: v.double() for k, v in p0.items()}
    batches = _batches()
    trainer = build_seg_trainer(EXPERIMENTS["SEAM_deeplabv1_resnet38"], torch.device("cpu"),
                                SEED)
    trainer.model.double().load_state_dict(p0, strict=True)
    losses, grads = [], {}
    for t, (img, label) in enumerate(batches):
        losses.append(trainer.step(img, label)["loss"])
        if t == 0:
            grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()
                     if p.grad is not None}
    ref = deeplab.steps(p0, batches, CFG, torch.Generator().manual_seed(SEED))
    return {"losses": losses, "grads": grads, "state": trainer.model.state_dict()}, ref, p0


def test_losses_match(runs):
    got, ref, _ = runs
    for a, b in zip(got["losses"], ref["loss"], strict=True):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), (float(a), float(b))


def test_every_trained_leaf_gets_the_reference_gradient(runs):
    got, ref, _ = runs
    assert got["grads"].keys() == ref["grad"].keys()
    # BN affine gets none; every conv weight and cls_conv's bias does
    assert not any(".bn" in k or k.startswith("bn") for k in got["grads"])
    worst = max(_rel(got["grads"][k], g) for k, g in ref["grad"].items())
    assert worst <= 2e-6, worst  # 1.4e-7 read


def test_state_after_two_steps_matches(runs):
    got, ref, p0 = runs
    assert got["state"].keys() == ref["params"].keys()
    for k, want in ref["params"].items():
        if k.endswith(("running_mean", "running_var")):
            # the statistics' change: 3e-4 of each step's batch moments
            assert _rel(got["state"][k] - p0[k], want - p0[k]) <= 2e-6, k
        elif deeplab.lr_mult(k) == 0:
            assert torch.equal(got["state"][k], p0[k]), k  # frozen BN affine
        else:
            assert _rel(got["state"][k] - p0[k], want - p0[k]) <= 2e-6, k  # 1.4e-7 read
