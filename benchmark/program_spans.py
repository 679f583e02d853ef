"""The traced window read by the host's main-thread ranges, the program's own
("wseg.*") and the benchmark's ("wsegbench.*"):

- `idle_by_range`: every idle stretch of the card split by the innermost
  range that covers each instant of it (the window itself excluded); an
  instant under no range is charged to "outside". The idle stretches are
  those of `benchmark/trace.py`: the gaps between the device's operations
  (kernels, copies, memsets) inside the window, and the window's two ends.
- `device_by_range`: the device time of every operation charged to each
  range the main thread was inside when the operation was launched, from
  any thread (autograd's backward launches from its own).

Why not the profiler's `key_averages()` by range name: it adds, under a
range's name, the device's copy of the range ("gpu_user_annotation", which
spans from the first to the last operation launched with the range
innermost, idle gaps included) to the operations of the aten ops inside
it, and misses operations launched outside any aten op (K1's, through
ctypes) or on another thread (PERF.md).

`benchmark/trace.py:Trace` keeps no events once it has read them, and a
profiler's Chrome trace can be saved once only, so `of` reads the traced
run's profiler's own event list (`profile.events()`) in the Chrome trace's
terms: the profiler is found on the stack of the reader's caller, which
holds it while the metrics are read.
"""

from __future__ import annotations

import sys
import weakref
from typing import NamedTuple

from benchmark.spans import PREFIX
from benchmark.trace import DEVICE_CATS, _union

PROGRAM = "wseg."
OUTSIDE = "outside"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

_READINGS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class Reading(NamedTuple):
    idle: dict[str, float]  # idle seconds by innermost range
    device: dict[str, float]  # device seconds by enclosing range


def _window(events):
    """(complete events, window start, end, main thread), or None."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == PREFIX + "window"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    return xs, win[0]["ts"], win[0]["ts"] + win[0]["dur"], win[0]["tid"]


def _ranges(xs, w0, w1, main_tid, window=False):
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
            if e.get("cat") == "user_annotation" and e.get("tid") == main_tid
            and e["name"].startswith((PROGRAM, PREFIX))
            and (window or e["name"] != PREFIX + "window")
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0]


def idle_by_range(events) -> dict[str, float]:
    """{range name: idle seconds} over the window of Chrome trace `events`;
    every main-thread range of the window is a key, "outside" too. The
    values sum to the window less the device's busy time."""
    found = _window(events)
    if found is None:
        return {}
    xs, w0, w1, main_tid = found
    dev = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in xs
           if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    _, gaps = _union(dev)
    if dev:
        idle = [(w0, min(s for s, _ in dev)), *gaps, (max(e for _, e in dev), w1)]
    else:
        idle = [(w0, w1)]
    ranges = _ranges(xs, w0, w1, main_tid)
    out = dict.fromkeys(sorted({name for _, _, name in ranges} | {OUTSIDE}), 0.0)
    pieces = _pieces(ranges, w0, w1)
    i = 0
    for s, e in idle:
        if e <= s:
            continue
        while pieces[i][1] <= s:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < e:
            a, b, chain = pieces[k]
            out[chain[0] if chain else OUTSIDE] += (min(b, e) - max(a, s)) / 1e6
            k += 1
    return out


def device_by_range(events) -> dict[str, float]:
    """{range name: device seconds} of the operations (kernels, copies,
    memsets) launched, from any thread, while the main thread was inside the
    range, the window included; found by the launch's "correlation"."""
    found = _window(events)
    if found is None:
        return {}
    xs, w0, w1, main_tid = found
    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = sorted((launched[c], e["dur"]) for e in xs if e.get("cat") in DEVICE_CATS
                 and (c := e.get("args", {}).get("correlation")) in launched
                 and w0 <= launched[c] < w1)
    ranges = _ranges(xs, w0, w1, main_tid, window=True)
    out = dict.fromkeys(sorted({name for _, _, name in ranges}), 0.0)
    pieces = _pieces(ranges, w0, w1)
    i = 0
    for t, dur in ops:
        while pieces[i][1] <= t:
            i += 1
        for name in set(pieces[i][2]):
            out[name] += dur / 1e6
    return out


def _pieces(ranges, w0, w1):
    """[(start, end, chain)] tiling [w0, w1): on each piece the names of the
    ranges that cover it, innermost first (the shortest; of two alike, the
    later)."""
    points = sorted({w0, w1} | {min(max(t, w0), w1) for s, e, _ in ranges for t in (s, e)})
    by_start = sorted(ranges)
    active, j, pieces = [], 0, []
    for a, b in zip(points, points[1:]):
        while j < len(by_start) and by_start[j][0] <= a:
            active.append(by_start[j])
            j += 1
        active = [r for r in active if r[1] > a]
        chain = tuple(r[2] for r in sorted(active, key=lambda r: (r[1] - r[0], -r[0])))
        pieces.append((a, b, chain))
    return pieces


def of(run) -> Reading | None:
    """Both splits of a traced run, read once and printed once on standard
    error; None where the run was not traced or its profiler is not found."""
    if run.trace is None:
        return None
    if run not in _READINGS:
        _READINGS[run] = _read()
    return _READINGS[run]


def _read():
    from torch.profiler import profile

    prof = _profiler_on_stack(profile)
    if prof is None:
        print("program_spans: no profiler on the stack; nothing read", file=sys.stderr)
        return None
    events = chrome_events(prof.events())
    reading = Reading(idle_by_range(events), device_by_range(events))
    for what, split in zip(("idle", "device time"), reading):
        print(f"{what} by range (s): " + ", ".join(f"{k} {v:.6f}" for k, v in split.items()),
              file=sys.stderr, flush=True)
    return reading


def chrome_events(function_events) -> list[dict]:
    """The profiler's `FunctionEvent`s as the Chrome trace's complete events
    ("ph" X, times in us): a host range of the program or the benchmark is a
    "user_annotation", a CUDA runtime or driver call (named "cu...") a
    "cuda_runtime", every other device event a "kernel", each of the last
    two with its "correlation"; the device's copies of the host's ranges
    ("gpu_user_annotation") are left out."""
    from torch.autograd import DeviceType

    def annotation(e):
        return getattr(e, "is_user_annotation", False) or e.name.startswith((PROGRAM, PREFIX))

    host_ranges = {e.name for e in function_events
                   if e.device_type == DeviceType.CPU and annotation(e)}
    out = []
    for e in function_events:
        args = {}
        if e.device_type == DeviceType.CPU:
            if annotation(e):
                cat = "user_annotation"
            elif e.name.startswith("cu"):
                cat, args = "cuda_runtime", {"correlation": e.id}
            else:
                cat = "cpu_op"
        elif annotation(e) or e.name in host_ranges:
            continue
        else:
            cat, args = "kernel", {"correlation": e.id}
        out.append({"ph": "X", "name": e.name, "cat": cat, "ts": e.time_range.start,
                    "dur": e.time_range.end - e.time_range.start, "tid": e.thread,
                    "args": args})
    return out


def _profiler_on_stack(kind):
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, kind):
                return value
        frame = frame.f_back
    return None


def _traced(run) -> Reading | None:
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return of(run)


def device_s(run, *names) -> float | None:
    """Device seconds of the operations launched under the program's ranges
    `names` in the traced window; None where the window shows no device
    work or the program has none of these ranges."""
    reading = _traced(run)
    if reading is None or not any(n in reading.device for n in names):
        return None
    return sum(reading.device.get(n, 0.0) for n in names)


def idle_pct(run, *names) -> float | None:
    """The share of the traced window in which the card was idle while the
    main thread's innermost range was one of `names`; None where the window
    shows no device work or the program has none of these ranges."""
    reading = _traced(run)
    if reading is None or not any(n in reading.idle for n in names):
        return None
    return 100.0 * sum(reading.idle.get(n, 0.0) for n in names) / run.trace.window_s
