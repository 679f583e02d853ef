"""The stage-3 training cell on the CPU at tiny spatial sizes and full widths:
a sound run is correct and reports its metrics, and `correct` comes out
false where the timed path is broken underneath: a step on half the batch,
and a step that leaves the state unchanged."""

import pytest
import torch
from conftest import edit

from benchmark import faults, harness
from benchmark.spec import Spec

SEG = "train.deeplab_v1_r38.crop448_b10"
CPU = torch.device("cpu")


# The card's limits are set at crop 448, where each deep BN averages 31,360
# values a channel. Here it averages 32, and float32 rounding grows through
# the 39 BNs: sound runs at crop 48 read loss_gap 6e-5-1.1e-4 and
# running_gap 3e-5-7e-5 (tests/test_torch_seg_reference.py finds the same
# in float32), so the tiny cell has limits of its own, which both faults
# still fail by far.
TINY_LIMITS = {"loss1_gap": 2e-5, "loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3,
               "running_gap": 1e-3}


@pytest.fixture(scope="module")
def seg_tiny(tiny):
    """The tiny copy with this cell at batch 2, crop 32, and images of 20 x 28
    and 28 x 20 before scaling, so every crop has a 255 pad."""
    def cut(d):
        d["traffic"].update(batch=2, crop=32, pool_batches=4,
                            sizes=[[[20, 28], 0.5], [[28, 20], 0.5]])
        d["check"]["limits"] = TINY_LIMITS

    edit(tiny.dir / "workloads" / f"{SEG}.json", cut)
    return Spec(tiny.root)


def run(spec):
    return harness.run(SEG, 2**31 + 4242, 0.05, False, device=CPU, spec=spec)


def seg_half_batch():
    """Half of each batch left out, the loss the mean over the rest."""
    import wseg_tpu_torch.train.seg as seg

    def make(orig):
        def make_seg_train_step(*args, **kw):
            step = orig(*args, **kw)
            return lambda img, label: step(img[: len(img) // 2], label[: len(label) // 2])
        return make_seg_train_step

    return faults._patched(seg, "make_seg_train_step", make)


def test_a_sound_run_is_correct_and_reports_its_metrics(seg_tiny):
    r = run(seg_tiny)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss1_gap", "loss_gap", "grad_gap", "change_gap",
                                "running_gap", "frozen_moved"}
    assert r["checks"]["frozen_moved"]["value"] == 0.0
    assert set(r["metrics"]) == {"images_per_s.train", "setup_s"}
    assert r["attempted"] >= 2 and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_broken_step_fails(seg_tiny, fault):
    with (seg_half_batch() if fault == "half_batch" else faults.state_unchanged()):
        r = run(seg_tiny)
    assert not r["correct"]
    if fault == "state_unchanged":
        assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
        assert r["checks"]["change_gap"]["value"] > 0.5
