"""Build the port's CUDA kernels from the sources in csrc/ and load them.

Each source is compiled by `nvcc` into a shared library with a plain C
interface (no PyTorch headers: seconds, not minutes) and loaded with ctypes.
Libraries go to `<repo>/build/wseg_tpu_torch/`, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
not. Nothing is built at import time: the first launch builds, and
`build_all()` builds every kernel at once, one nvcc per source in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wseg_tpu_torch"
SOURCES = ("pcm", "conv3x3")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _tmp(target: Path) -> Path:
    return target.with_suffix(f".{os.getpid()}.tmp")


def _start(name: str) -> subprocess.Popen | None:
    """Start nvcc for `name` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(target)), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen | None) -> Path:
    target = _target(name)
    if proc is None:
        return target
    log, _ = proc.communicate()
    (BUILD_DIR / f"{target.stem}.log").write_text(log)
    if proc.returncode != 0:
        _tmp(target).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(_tmp(target), target)
    return target


def build_all() -> dict[str, Path]:
    """Build every kernel source, all nvcc processes started together."""
    procs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, proc) for name, proc in procs.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the last build."""
    log = BUILD_DIR / f"{_target(name).stem}.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build `name` if needed and load it."""
    return ctypes.CDLL(str(_finish(name, _start(name))))
