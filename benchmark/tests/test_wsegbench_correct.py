"""`correct` comes out false where the timed path is broken underneath
(benchmark/faults.py), and for the control: the reference in the next
precision down in the program's place. The faults and the CAM control run
on the CPU; the training control (TF32) needs the card."""

import pytest
import torch
from conftest import CAM, TRAIN

from benchmark import faults, harness

CPU = torch.device("cpu")


def run(tiny, cell, device=CPU, control=False):
    return harness.run(cell, 424242, 0.05, False, device=device, spec=tiny, control=control)


def test_cam_control_fails(tiny):
    assert not run(tiny, CAM, control=True)["correct"]


@pytest.mark.parametrize("fault", ["answer_altered", "cam_half_batch"])
def test_cam_fault_fails(tiny, fault):
    with faults.FAULTS[fault]():
        assert not run(tiny, CAM)["correct"]


def test_train_a_step_that_leaves_the_state_unchanged_fails(tiny):
    with faults.state_unchanged():
        r = run(tiny, TRAIN)
    assert not r["correct"]
    # no leaf moved and no gradient reached the optimizer: every leaf's gap
    # is 1 where the reference's norm is at least the median leaf's, so the
    # median leaf's gap is about 1
    assert r["checks"]["change_gap"]["value"] > 0.5
    assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out_fails(tiny):
    with faults.train_half_batch():
        assert not run(tiny, TRAIN)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [CAM, TRAIN])
def test_control_fails_on_the_card(tiny, card, cell):
    assert not run(tiny, cell, device=card, control=True)["correct"]
