"""Profiling hooks (counterpart of wseg_tpu/utils/profiling.py) on
torch.profiler.

- `span(name)` opens the range `wseg.<name>` inside a recording
  `torch.profiler` session, so the program's layers sit on the device
  trace's timeline beside the kernels and copies they launched; outside
  one it is a shared no-op context, and costs one check.
- `count(name, n)` adds to `counters` under the same gate, so a recorded
  window's counts are that window's alone; `reset()` empties them.
- `trace(logdir)` records the block's host and device activity and writes
  it as a Chrome trace (chrome://tracing, Perfetto) into `logdir`.

The check is the calling thread's: work on other threads (the CLIs'
prefetch pools) is neither spanned nor counted.
"""

from __future__ import annotations

import contextlib
import os

import torch

PREFIX = "wseg."

counters: dict[str, int] = {}

_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span("cam.forward"): ...` names the block in a recorded trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add `n` to `counters[name]` while a profiler session records."""
    if torch.autograd._profiler_enabled():
        counters[name] = counters.get(name, 0) + n


def reset() -> None:
    counters.clear()


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block into `<logdir>/trace_<pid>.json`, with the block's
    counters printed in one line at its end; a no-op when `logdir` is empty.
    The card's activity is recorded when there is one."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"wrote a profiler trace to {path}", flush=True)
    print("counters: " + (", ".join(f"{k} {v}" for k, v in sorted(counters.items()))
                          or "none"), flush=True)
