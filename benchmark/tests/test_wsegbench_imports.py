"""What the command loads: never JAX or the JAX package (top-level names
compared whole: wseg_tpu_torch is not wseg_tpu), and the reference loads
nothing of the program. Without a card the command prints no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from conftest import CAM, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "wseg_tpu"}
ENV = {**os.environ, "PYTHONPATH": ""}


def python(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_the_port_and_never_jax(tiny):
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(REPO)!r})
torch.set_num_threads(4)
from benchmark import harness
from benchmark.spec import Spec
from pathlib import Path
harness.run({CAM!r}, 9, 0.05, False, device=torch.device("cpu"), spec=Spec(Path({str(tiny.root)!r})))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = python(code, REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "wseg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "wseg_tpu_torchx", sys)
    assert "wseg_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wseg_tpu.models", sys)
    assert harness.forbidden_modules() == ["wseg_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"wseg_tpu_torch"}, (path, name)
    out = python("import sys; sys.path.insert(0, '.'); import benchmark.reference.cam, "
                 "benchmark.reference.train; print(sorted({m.split('.')[0] for m in "
                 "sys.modules}))", REPO)
    assert out.returncode == 0, out.stderr
    assert "wseg_tpu_torch" not in out.stdout and "'jax'" not in out.stdout


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CAM, "--seed",
                          "1", "--seconds", "1"], cwd=REPO, env=ENV, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import json, sys, torch; sys.path.insert(0, '.'); from benchmark import harness; "
            f"print(json.dumps(harness.run({CAM!r}, 1, 0.05, False, device=torch.device('cpu'))))")
    out = python(code, tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    assert "wseg_tpu_torch" in out.stderr
