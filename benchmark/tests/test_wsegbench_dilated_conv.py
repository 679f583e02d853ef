"""The readers of the trunk's dilation-4 convs on K2 (`dilated_conv_*`), on a
synthetic traced training window of 1000 us: two steps, each with a
"wseg.conv.dilated" range around one 100 us kernel, and the program's
counters faked. A program without the range or the counters (the parent of
the change that added them) reports none of the three."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import Run
from benchmark.peaks import PEAKS
from benchmark.spec import Spec

MAIN, AUTOGRAD = 1, 2
NEW = ["dilated_conv_ms_per_step", "dilated_conv_roofline_pct", "dilated_conv_k2_pct"]

# (name, start, end) of the main thread's ranges
RANGES = [("wsegbench.window", 0, 1000), ("wseg.train.step", 0, 480),
          ("wseg.conv.dilated", 100, 110), ("wseg.train.step", 500, 980),
          ("wseg.conv.dilated", 600, 610)]
# (name, start, end, launched at, thread): K2 under its range, a cuDNN conv
# outside it, a backward kernel from autograd's thread
KERNELS = [("conv3x3_f32_kernel", 120, 220, 105, MAIN),
           ("cudnn_conv", 230, 400, 200, MAIN),
           ("conv3x3_f32_kernel", 620, 720, 605, MAIN),
           ("dgrad", 730, 900, 700, AUTOGRAD)]


def events(program=True):
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": MAIN}
           for n, s, e in RANGES if program or not n.startswith("wseg.")]
    for i, (n, s, e, t, tid) in enumerate(KERNELS):
        out.append({"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s, "tid": 7,
                    "args": {"correlation": 100 + i}})
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                    "dur": 2, "tid": tid, "args": {"correlation": 100 + i}})
    return out


class FakeTorchProfiler(torch.profiler.profile):
    """A profiler whose `events()` are the synthetic trace's, as FunctionEvents
    (`program_spans` finds it on the reader's stack)."""

    def __init__(self, evs):
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        self.function_events = [SimpleNamespace(
            name=e["name"], thread=e["tid"], is_user_annotation=e["cat"] == "user_annotation",
            device_type=cpu if e["cat"] in ("user_annotation", "cuda_runtime") else cuda,
            id=e.get("args", {}).get("correlation", -1),
            time_range=SimpleNamespace(start=e["ts"], end=e["ts"] + e["dur"])) for e in evs]

    def events(self):
        return self.function_events


def run(busy=True):
    trace = SimpleNamespace(busy_s=540e-6 if busy else 0.0, window_s=1e-3)
    return Run(None, trace=trace, steps=2, window_s=1e-3, peaks=PEAKS["SXM"])


FLOPS = 2 * 9 * 1024 * 2048 * 8 * 56 * 56  # b7 at crop 448, batch 8


def test_the_readers_on_a_synthetic_run(monkeypatch):
    from wseg_tpu_torch.utils import profiling

    spec = Spec()
    prof = FakeTorchProfiler(events())  # noqa: F841 (found on the stack)
    monkeypatch.setitem(profiling.counters, "conv.dil4_calls", 4)
    monkeypatch.setitem(profiling.counters, "conv.dil4_k2", 3)
    monkeypatch.setitem(profiling.counters, "conv.dil4_flops", FLOPS)
    got = {m: spec.reader(m)(run()) for m in NEW}
    assert got["dilated_conv_ms_per_step"] == pytest.approx(0.1, rel=1e-9)  # 200 us / 2 steps
    assert got["dilated_conv_roofline_pct"] == pytest.approx(100 * FLOPS / 200e-6 / 67e12,
                                                             rel=1e-9)
    assert got["dilated_conv_k2_pct"] == pytest.approx(75.0, rel=1e-9)


def test_the_readers_report_nothing_without_the_programs_range_or_counters(monkeypatch):
    from wseg_tpu_torch.utils import profiling

    spec = Spec()
    prof = FakeTorchProfiler(events(program=False))  # noqa: F841
    for k in ("conv.dil4_calls", "conv.dil4_k2", "conv.dil4_flops"):
        monkeypatch.delitem(profiling.counters, k, raising=False)
    for m in NEW:
        assert spec.reader(m)(run()) is None, m
    assert spec.reader("dilated_conv_k2_pct")(Run(None, trace=None)) is None
    monkeypatch.setitem(profiling.counters, "conv.dil4_calls", 4)
    assert spec.reader("dilated_conv_k2_pct")(run()) == 0.0  # calls, none on K2
    assert spec.reader("dilated_conv_k2_pct")(run(busy=False)) is None
