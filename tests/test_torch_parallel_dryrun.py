"""The multi-process dry run of the port (cli/dryrun_multichip.py, the twin
of __graft_entry__.dryrun_multichip): one full-width step of each trainer
on gloo CPU ranks spawned over a file store, at 2 ranks, and at 8 under the
`slow` marker, as tests/test_train_step.py runs the JAX one: 8 full-width
ranks each hold a model of 106-124 M parameters with its gradients and
momentum, and share the host's cores."""

import contextlib
import io

import pytest


def _dryrun(n, tmp_path):
    from wseg_tpu_torch.cli.dryrun_multichip import dryrun_multichip

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(n, timeout=600.0, workdir=str(tmp_path))
    return out.getvalue().splitlines()


def test_dryrun_multichip_2(tmp_path):
    """One full-width step of each trainer on 2 ranks: finite losses, equal
    on the ranks; stage-3 BN statistics moved and equal on both ranks; the
    JAX dry run's lines."""
    lines = _dryrun(2, tmp_path)
    assert [line.split()[1] for line in lines[:3]] == ["stage1", "stage2", "stage3"]
    assert lines[-1].startswith("dryrun_multichip(2) OK: loss=")


@pytest.mark.slow
def test_dryrun_multichip_8(tmp_path):
    lines = _dryrun(8, tmp_path)
    assert lines[-1].startswith("dryrun_multichip(8) OK: loss=")
