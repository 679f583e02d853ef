"""kernels/_build.py on the CPU: a library's name hashes its source and every
csrc/ header that the source includes, so an edited header rebuilds the
libraries that include it and leaves the others alone. Needs no nvcc."""

import shutil

import pytest

from wseg_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
def test_sources_follow_includes(csrc, name):
    found = {p.name for p in _build.sources(name)}
    assert found == {f"{name}.cu", "hopper.cuh"}


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_the_shared_header_renames_the_target(csrc, name):
    before = _build._target(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"lib{name}_") and after.suffix == ".so"


def test_editing_one_source_leaves_the_other_target(csrc):
    before = {name: _build._target(name) for name in _build.SOURCES}
    src = csrc / "pcm.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("pcm") != before["pcm"]
    assert _build._target("conv3x3") == before["conv3x3"]


def test_nested_include_is_hashed(csrc):
    (csrc / "extra.cuh").write_text("#pragma once\n")
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + '\n#include "extra.cuh"\n')
    assert "extra.cuh" in {p.name for p in _build.sources("conv3x3")}
    before = _build._target("conv3x3")
    (csrc / "extra.cuh").write_text("#pragma once\n// edited\n")
    assert _build._target("conv3x3") != before
