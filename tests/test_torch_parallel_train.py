"""One full-width step of each trainer on 2 gloo ranks against one process at
the same global batch (wseg_tpu_torch/parallel/, the rule: W ranks at global
batch B compute the one-process step at batch B).

Each trainer runs two steps from weights made from a seed, dropout on (both
sides draw the same masks at the global shape), on batches whose two
samples have different label counts (stage 1: one class and three; stage
2: other pair-label densities; stage 3: 10% and 50% of the pixels ignored),
so a per-rank normaliser would show. The tolerances are the JAX package's
own data-parallel tests' (tests/test_cli_train_dp.py:200-212): metrics
rtol 1e-4, the GRAD_TARGETS gradients after step 1 and every parameter
after step 2 atol 5e-5 / rtol 1e-3; stage 3's running statistics the same
plus one float32 ulp of the stored value (tests/test_torch_seg_train.py's
rule). The ranks end with identical parameters and buffers, and the frozen
parameters stay where they started."""

import os

import numpy as np
import pytest
import torch

from test_torch_models import drop_tmp_path  # noqa: F401 (an autouse fixture)
from wseg_tpu_torch.ops.pairs import radius_pair_indices, search_offsets
from wseg_tpu_torch.parallel.launch import spawn

import torch_dp_workers as workers

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300.0  # seconds a spawn may take: a hang fails the test, never the suite
RTOL_LOSS, ATOL, RTOL = 1e-4, 5e-5, 1e-3


def batches(kind):
    """Two global batches of 2 for trainer `kind`, from a seed, at the JAX dry
    run's small shapes (stage 1 at 32, stage 2 at 48: the smallest map with
    pairs) and stage 3 at 40x56."""
    rng = np.random.RandomState({"contrast": 21, "affinity": 22, "seg": 23}[kind])
    out = []
    for _ in range(2):
        if kind == "contrast":
            img = (rng.randn(2, 3, 32, 32) * 0.5).astype(np.float32)
            label = np.zeros((2, 20), np.float32)
            label[0, 2] = label[1, [6, 11, 14]] = 1
            out.append((img, label))
        elif kind == "affinity":
            img = (rng.randn(2, 3, 48, 48) * 0.5).astype(np.float32)
            radius = 2  # the 6x6 map's clamped radius
            shape = (2, len(search_offsets(radius)), radius_pair_indices(radius, (6, 6))[0].shape[0])
            dens = np.array([0.15, 0.6], np.float32)[:, None, None]
            out.append((img, *((rng.rand(*shape) < dens * s).astype(np.float32)
                               for s in (1.0, 0.5, 0.8))))
        else:
            img = rng.randn(2, 3, 40, 56).astype(np.float32)
            lab = rng.randint(0, 21, (2, 40, 56))
            lab[rng.rand(2, 40, 56) < np.array([0.1, 0.5])[:, None, None]] = 255
            out.append((img, lab))
    return out


KINDS = ("contrast", "affinity", "seg")


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{kind: (the 2 ranks' results, the one-process result)}: one spawn runs
    the three trainers, then this process computes the references (one
    after the other: torch's threads spin when processes share the cores)."""
    calls = [("train", dict(kind=kind, batches=batches(kind))) for kind in KINDS]
    ranks = spawn("torch_dp_workers:many", 2, tmp_path_factory.mktemp("train"),
                  dict(calls=calls), timeout=TIMEOUT, pythonpath=[TESTS])
    return {kind: ([r[i] for r in ranks], workers.train(None, **kwargs))
            for i, (kind, (_, kwargs)) in enumerate(zip(KINDS, calls))}


@pytest.fixture(params=KINDS)
def runs(request, all_runs):
    """(kind, the 2-rank results, the one-process result)."""
    return (request.param, *all_runs[request.param])


def test_metrics_match_one_process(runs):
    """Every metric of both steps, on both ranks, within rtol 1e-4."""
    _, ranks, one = runs
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got.keys() == want.keys()
            for key in want:
                if key != "pred":
                    np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                               rtol=RTOL_LOSS, err_msg=key)


def test_gradients_match_one_process(runs):
    """The GRAD_TARGETS gradients after step 1 (averaged over the ranks, and
    clipped for stage 1) on both ranks, atol 5e-5 / rtol 1e-3; none is 0."""
    kind, ranks, one = runs
    for r in ranks:
        for name in workers.GRAD_TARGETS[kind]:
            want = one["grads"][name].numpy()
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(r["grads"][name].numpy(), want, atol=ATOL, rtol=RTOL,
                                       err_msg=name)


def test_state_matches_one_process(runs):
    """After step 2: every parameter atol 5e-5 / rtol 1e-3, the frozen ones
    equal to the one process's (both unmoved); stage 3's running statistics
    atol 5e-5 / rtol 1e-3 plus one ulp, stages 1 and 2's (frozen BN) equal;
    parameters and buffers the same on both ranks."""
    kind, ranks, one = runs
    assert all(r["same"] for r in ranks)
    got, want = ranks[0]["state"], one["state"]
    assert got.keys() == want.keys()
    params = {k for k, v in got.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))}
    assert one["frozen"] and one["frozen"] <= params
    for key in params:
        if key in one["frozen"]:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        else:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=key)
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        g, w = got[key].numpy(), want[key].numpy()
        if kind == "seg":
            assert np.all(np.abs(g - w) <= ATOL + RTOL * np.abs(w) + np.spacing(np.abs(w))), key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
