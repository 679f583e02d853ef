"""Where the benchmark's files are, and how a name finds its file.

BENCHMARK.json at the root of the checkout lists the cells and metrics;
each cell, configuration, driver and metric is a file of its own here:
`workloads/<cell>.json`, `configs/<config>.json`, `drivers/<driver>.py`,
`metrics/<metric>.py`. Adding one is adding files and entries; no code
names them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """The benchmark rooted at `root` (the checkout)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        listed = {w["name"]: w for w in self.bench["workloads"]}
        if name not in listed:
            raise SystemExit(f"workload {name!r} is not in BENCHMARK.json")
        cell = json.loads((self.dir / "workloads" / f"{name}.json").read_text())
        for key in ("config", "chips"):
            if cell.get(key) != listed[name][key]:
                raise SystemExit(f"workloads/{name}.json has {key} {cell.get(key)!r}, "
                                 f"BENCHMARK.json {listed[name][key]!r}")
        cell["name"] = name
        return cell

    def config(self, name: str) -> dict:
        return json.loads((self.dir / "configs" / f"{name}.json").read_text())

    def driver(self, name: str):
        return _load(self.dir / "drivers" / f"{name}.py", f"wsegbench_driver_{name}")

    def metrics_of(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end ones untraced,
        its per-layer ones traced. A metric with a "workloads" list belongs to
        those cells; a per-layer metric without one belongs to every cell that
        reports the end-to-end metric it moves."""
        def mine(m):
            return cell["name"] in m.get("workloads", [cell["name"]])

        e2e = [m for m in self.bench["end_to_end"] if mine(m)]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if mine(m) and ("workloads" in m or m["moves"] in reported)]

    def reader(self, metric: str):
        """`metrics/<metric>.py`; a metric split by cells (`mfu_pct.train`)
        reads with its quantity's file (`metrics/mfu_pct.py`) unless it has
        one of its own."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return _load(path, f"wsegbench_metric_{metric}").read


def _load(path: Path, module_name: str):
    if not path.exists():
        raise SystemExit(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
