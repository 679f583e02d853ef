"""A configuration, a cell and a metric are added by adding files and entries:
the harness finds them by name, and no existing file changes."""

import hashlib
import json

import torch
from conftest import CAM

from benchmark import harness
from benchmark.spec import Spec


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_added_files_are_found_without_edits(tiny):
    root = tiny.root
    before = digests(root)
    cfg = json.loads((root / "benchmark/configs/contrast_r38.json").read_text())
    cfg["name"] = "contrast_r38_again"
    (root / "benchmark/configs/contrast_r38_again.json").write_text(json.dumps(cfg))
    cell = json.loads((root / f"benchmark/workloads/{CAM}.json").read_text())
    cell["config"] = "contrast_r38_again"
    cell["traffic"]["batch"] = 2
    new_cell = "cam_infer.contrast_r38_again.b2"
    (root / f"benchmark/workloads/{new_cell}.json").write_text(json.dumps(cell))
    (root / "benchmark/metrics/batches_per_s.py").write_text(
        "def read(run):\n    return run.steps / run.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="contrast_r38_again",
                                 file="benchmark/configs/contrast_r38_again.json"))
    bench["workloads"].append({"name": new_cell, "config": "contrast_r38_again",
                               "traffic": "b2", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": [new_cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        r = harness.run(new_cell, 3, 0.05, False, device=torch.device("cpu"), spec=Spec(root))
        assert r["correct"], r["checks"]
        assert "batches_per_s" in r["metrics"]
        after = digests(root)
        assert all(after[k] == v for k, v in before.items())
        # the metric belongs to its cell only
        assert "batches_per_s" not in [m["name"] for m in
                                       Spec(root).metrics_of(Spec(root).cell(CAM), False)]
    finally:
        for p in ("benchmark/configs/contrast_r38_again.json",
                  f"benchmark/workloads/{new_cell}.json", "benchmark/metrics/batches_per_s.py"):
            (root / p).unlink()
        (root / "BENCHMARK.json").write_text(json.dumps(
            {**bench, "configs": bench["configs"][:-1], "workloads": bench["workloads"][:-1],
             "end_to_end": bench["end_to_end"][:-1]}))


def test_every_name_in_benchmark_json_has_its_files():
    spec = Spec()
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in spec.bench["configs"]:
        assert (spec.root / c["file"]).exists()
    for w in spec.bench["workloads"]:
        cell = spec.cell(w["name"])
        spec.config(cell["config"])
        spec.driver(cell["driver"])
