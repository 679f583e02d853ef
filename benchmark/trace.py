"""The traced run's reading of `torch.profiler`: the device's timeline inside
the measured window, device time by host range, and the breakdown.

The profiler's Chrome trace is written to a scratch file, read back and
deleted. Device operations are its "kernel", "gpu_memcpy" and
"gpu_memset" events; the window is the "wsegbench.window" range; the host
was in the innermost "wsegbench.*" range of the main thread when an idle
gap began. Device time under a host range (an aten op, the optimizer's
step) comes from `key_averages()`, which counts the kernels each op
launched, its children's included.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path

from benchmark.spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals):
    """Total length of the union of [start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class Trace:
    """What a traced window shows. Times in seconds."""

    def __init__(self, prof, scratch: Path):
        path = Path(scratch) / f"trace_{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        try:
            events = json.loads(path.read_text())["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == PREFIX + "window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no wsegbench.window range")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.window_s = (w1 - w0) / 1e6
        dev = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e["name"])
               for e in xs if e.get("cat") in DEVICE_CATS
               and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
        self.kernels = [(n, (e - s) / 1e6) for s, e, n in dev]
        busy, gaps = _union([(s, e) for s, e, _ in dev])
        self.busy_s = busy / 1e6
        main_tid = win[0]["tid"]
        ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in xs
                  if e.get("cat") == "user_annotation" and e.get("tid") == main_tid
                  and e["name"].startswith(PREFIX) and e["name"] != PREFIX + "window"]
        if dev:  # the idle stretches: the gaps, and the window's two ends
            edges = [(w0, min(s for s, _, _ in dev)), *gaps, (max(e for _, e, _ in dev), w1)]
        else:
            edges = [(w0, w1)]
        self.gaps = sorted(((e - s) / 1e6, _innermost(ranges, s)) for s, e in edges if e > s)
        self.gaps.reverse()
        self.device_time_under = _device_time_by_key(prof)

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for name, sec in self.kernels:
            by[name] += sec
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def top_gaps(self, k: int = 10):
        return [[name, sec] for sec, name in self.gaps[:k]]


def _innermost(ranges, t):
    inside = [(e - s, name) for s, e, name in ranges if s <= t < e]
    return min(inside)[1] if inside else "outside any benchmark span"


def _device_time_by_key(prof) -> dict:
    """{op or range name: device seconds of the kernels it launched}."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        out[e.key] = out.get(e.key, 0.0) + us / 1e6
    return out
