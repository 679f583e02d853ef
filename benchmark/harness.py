"""One run of one cell: set-up, the measured window, the readings, `correct`.

`run` is the whole run after the command's checks of the card; the CPU tests
call it directly at tiny sizes. The window runs whole batches or steps and
ends at the first boundary after `seconds`, after a synchronize; every rate
is the window's work over all of its time. With `trace`, the window runs
under `torch.profiler` and the per-layer metrics are read from it and from
the benchmark's spans; without, the end-to-end metrics are reported.
"""

from __future__ import annotations

import functools
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark import peaks
from benchmark import trace as tracing
from benchmark.spans import PREFIX, Spans
from benchmark.spec import Spec

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "wseg_tpu"})

BACKEND = {
    "cudnn.benchmark": (torch.backends.cudnn, "benchmark"),
    "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (wseg_tpu_torch is not wseg_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def backend_flags() -> dict:
    return {k: bool(getattr(obj, attr)) for k, (obj, attr) in BACKEND.items()}


def apply_backend(flags: dict) -> None:
    for k, v in flags.items():
        obj, attr = BACKEND[k]
        setattr(obj, attr, bool(v))


@dataclass
class Context:
    """What a driver is given."""
    cell: dict
    config: dict
    seed: int
    device: torch.device
    workdir: Path
    spans: Spans


class Run:
    """What a metric's reader is given. Times in seconds."""

    def __init__(self, session, **kw):
        self.session = session
        self.__dict__.update(kw)

    @functools.cached_property
    def work(self) -> dict:
        """The reference's count of the window's work (FLOPs, K1's work)."""
        return self.session.work()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: torch.device,
        spec: Spec | None = None, t_start: float | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object (checks last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    flags = config["backend"][cell["cli"]]
    apply_backend(flags)
    print(f"backend flags of {cell['cli']} applied: {backend_flags()}", flush=True)
    workdir = Path(tempfile.gettempdir()) / "wsegbench" / workload
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        return _run(spec, cell, config, flags, seed, seconds, trace, device, workdir,
                    t_start, control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(spec, cell, config, flags, seed, seconds, trace, device, workdir, t_start, control):
    on_gpu = device.type == "cuda"
    ctx = Context(cell, config, seed, device, workdir, Spans())
    session = spec.driver(cell["driver"]).Session(ctx)
    session.setup()
    _sync(device)
    if backend_flags() != {k: bool(v) for k, v in flags.items()}:
        print(f"backend flags in effect after set-up: {backend_flags()}", flush=True)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)

    prof = tracing.profiler() if trace else None
    images = steps = 0
    session.begin_window()
    if prof is not None:
        prof.__enter__()
    try:
        with torch.profiler.record_function(PREFIX + "window"):
            t0 = time.perf_counter()
            while True:
                images += session.step()
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
            t1 = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    session.end_window()
    print("host spans in the window (seconds, count): " + ", ".join(
        f"{n} {sec:.3f} ({c})" for n, (c, sec) in sorted(ctx.spans.totals(t0, t1).items())),
        flush=True)
    window_peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    card = torch.cuda.get_device_name(device) if on_gpu else "cpu"
    traced = tracing.Trace(prof, workdir) if prof is not None else None

    r = Run(session, cell=cell, config=config, seed=seed, on_gpu=on_gpu, trace=traced,
            window=(t0, t1), window_s=t1 - t0, setup_s=setup_s, images=images, steps=steps,
            spans=ctx.spans, counters=getattr(session, "counters", {}),
            peak_window_bytes=window_peak, card=card, peaks=peaks.of(card))
    metrics = {}
    for m in spec.metrics_of(cell, trace):
        value = spec.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    session.release()
    t_check = time.perf_counter()
    checks = session.check(control=control)
    print(f"the check took {time.perf_counter() - t_check:.1f} s", flush=True)
    failed = [name for name, value, limit in checks if not value <= limit]
    device_info = {"platform": "gpu" if on_gpu else "cpu", "kind": card,
                   "count": cell["chips"] if on_gpu else 0,
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": not failed, "attempted": images, "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.top_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result
