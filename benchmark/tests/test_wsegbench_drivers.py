"""Each driver end to end on the CPU at tiny spatial sizes and full widths:
set-up, a window, the metrics, and `correct` against the reference."""

from pathlib import Path

import pytest
import torch
from conftest import CAM, TRAIN

from benchmark import harness

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", [CAM, TRAIN])
def test_a_run_is_correct_and_reports_its_metrics(tiny, cell):
    r = harness.run(cell, 2**31 + 12345, 0.05, False, device=CPU, spec=tiny)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= tiny.cell(cell)["traffic"]["batch"]
    # on the CPU no device number is reported: peak memory is the card's
    part = "infer" if cell == CAM else "train"
    assert set(r["metrics"]) == {f"images_per_s.{part}", "setup_s"}
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_a_traced_run_reads_the_benchmarks_spans(tiny):
    r = harness.run(CAM, 7, 0.05, True, device=CPU, spec=tiny)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"input_wait_pct", "host_prep_ms_per_image"}
    assert r["metrics"]["host_prep_ms_per_image"]["value"] > 0
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_same_seed_makes_the_same_inputs(tiny):
    from benchmark.harness import Context
    from benchmark.spans import Spans

    cell = tiny.cell(CAM)
    driver = tiny.driver(cell["driver"])

    def session(seed):
        return driver.Session(Context(cell, tiny.config(cell["config"]), seed, CPU, Path("unused"),
                                      Spans()))

    a, b, c = session(2**33 + 1), session(2**33 + 1), session(5)
    assert a.sizes == b.sizes and (a.labels == b.labels).all()
    # another seed: the same work in another order
    assert sorted(a.sizes) == sorted(c.sizes)
    assert sorted(a.labels.sum(1)) == sorted(c.labels.sum(1))
