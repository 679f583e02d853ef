"""Profiling hooks (counterpart of wseg_tpu/utils/profiling.py) on
torch.profiler: `trace(logdir)` records the block's host and device activity
and writes it as a Chrome trace (chrome://tracing, Perfetto) into `logdir`;
`annotate(name)` names a span inside it."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block into `<logdir>/trace_<pid>.json`; a no-op when
    `logdir` is empty. The card's activity is recorded when there is one."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"wrote a profiler trace to {path}", flush=True)


def annotate(name: str):
    """A named span, e.g. `with annotate("train_step"): ...`."""
    return torch.profiler.record_function(name)
