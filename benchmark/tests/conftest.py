"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose cells
run at tiny spatial sizes (the configurations keep their full widths), and
the card for the tests marked `cuda`."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

CAM = "cam_infer.contrast_r38.voc_b16"
TRAIN = "train.contrast_r38.crop448_b8"


def edit(path: Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=2))


def tiny_copy(root: Path) -> Path:
    """The benchmark under `root`, its cells cut to tiny images and crops."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    wl = root / "benchmark" / "workloads"

    def cam(d):
        d["traffic"].update(images=8, batch=4,
                            sizes=[[[40, 56], 0.5], [[56, 40], 0.25], [[48, 48], 0.25]])
        d["check"]["images"] = 8

    def train(d):
        d["traffic"].update(batch=2, crop=64, pool_batches=4)

    edit(wl / f"{CAM}.json", cam)
    edit(wl / f"{TRAIN}.json", train)
    edit(root / "benchmark" / "configs" / "contrast_r38.json",
         lambda d: d["train"].update(low_res=32))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from benchmark.spec import Spec

    return Spec(tiny_copy(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    torch.set_num_threads(4)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
