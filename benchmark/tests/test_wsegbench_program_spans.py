"""The idle and device-time splits by host range
(`benchmark/program_spans.py`) and the readers of the program's spans and
counters, on synthetic traces: a window of 1000 us with the benchmark's
ranges, the program's ranges nested inside them, and the card busy 515 us
of it."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans
from benchmark.harness import Run
from benchmark.spec import Spec
from benchmark.trace import Trace

MAIN, PREP = 1, 2

BENCH_RANGES = [("wsegbench.window", 0, 1000), ("wsegbench.infer", 0, 900),
                ("wsegbench.write", 900, 980)]
PROGRAM_RANGES = [("wseg.cam.batch", 10, 890), ("wseg.cam.assemble", 10, 100),
                  ("wseg.cam.h2d", 100, 150), ("wseg.cam.forward", 150, 600),
                  ("wseg.model.trunk", 160, 500), ("wseg.cam.fuse", 600, 890)]
# (name, category, start, end, launched at, from thread)
DEVICE = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 120, 160, 110, MAIN),
          ("conv_kernel", "kernel", 170, 550, 165, MAIN),
          ("bwd_kernel", "kernel", 550, 560, 520, PREP),  # launched by another thread
          ("fuse_kernel", "kernel", 620, 700, 610, MAIN),
          ("warm_kernel", "kernel", 0, 5, -10, MAIN)]  # launched before the window
# idle: [5, 120) [160, 170) [560, 620) [700, 1000); the last crosses three ranges
# and ends under none
WANT = {"wsegbench.infer": 15e-6, "wsegbench.write": 80e-6, "outside": 20e-6,
        "wseg.cam.batch": 0.0, "wseg.cam.assemble": 90e-6, "wseg.cam.h2d": 20e-6,
        "wseg.cam.forward": 40e-6, "wseg.model.trunk": 10e-6, "wseg.cam.fuse": 210e-6}
# device time by the range the main thread was in at each launch
WANT_DEVICE = {"wsegbench.window": 510e-6, "wsegbench.infer": 510e-6, "wsegbench.write": 0.0,
               "wseg.cam.batch": 510e-6, "wseg.cam.assemble": 0.0, "wseg.cam.h2d": 40e-6,
               "wseg.cam.forward": 390e-6, "wseg.model.trunk": 380e-6,
               "wseg.cam.fuse": 80e-6}

NEW_CAM = ["trunk_ms_per_image", "pcm_ms_per_image", "upsample_fuse_ms_per_image",
           "h2d_ms_per_image", "bucket_fill_pct", "assemble_idle_pct", "readback_idle_pct"]


def events(program=True, device=True):
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": MAIN}
           for n, s, e in BENCH_RANGES + (PROGRAM_RANGES if program else [])]
    if program:  # another thread's range, and the device's copy of a host range
        out.append({"ph": "X", "cat": "user_annotation", "name": "wseg.data.prep",
                    "ts": 0, "dur": 1000, "tid": PREP})
        out.append({"ph": "X", "cat": "gpu_user_annotation", "name": "wseg.cam.forward",
                    "ts": 150, "dur": 450, "tid": 7})
    if device:
        for i, (n, c, s, e, t, tid) in enumerate(DEVICE):
            out.append({"ph": "X", "cat": c, "name": n, "ts": s, "dur": e - s, "tid": 7,
                        "args": {"correlation": 100 + i}})
            out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                        "dur": 2, "tid": tid, "args": {"correlation": 100 + i}})
    return out


class FakeProfiler:
    """What `Trace` reads of a profiler: a Chrome trace and key_averages."""

    def __init__(self, evs, device_time_under):
        self.evs, self.under = evs, device_time_under

    def export_chrome_trace(self, path):
        Path(path).write_text(json.dumps({"traceEvents": self.evs}))

    def key_averages(self):
        return [SimpleNamespace(key=k, device_time_total=v * 1e6) for k, v in self.under.items()]


class FakeTorchProfiler(torch.profiler.profile):
    """A profiler whose `events()` are the synthetic trace's, as FunctionEvents."""

    def __init__(self, evs):
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        self.function_events = [SimpleNamespace(
            name=e["name"], thread=e["tid"], is_user_annotation="annotation" in e["cat"],
            device_type=cpu if e["cat"] in ("user_annotation", "cuda_runtime") else cuda,
            id=e.get("args", {}).get("correlation", -1),
            time_range=SimpleNamespace(start=e["ts"], end=e["ts"] + e["dur"])) for e in evs]

    def events(self):
        return self.function_events


# key_averages' sums, as `Trace` reads them (the program's ranges' doubled)
UNDER = {"aten::cudnn_convolution": 380e-6, "wseg.model.trunk": 760e-6, "wseg.cam.h2d": 80e-6}


def trace(tmp_path, evs, under=UNDER):
    return Trace(FakeProfiler(evs, under), tmp_path)


def run(tr, images=2, steps=1):
    return Run(None, trace=tr, images=images, steps=steps, window_s=1e-3)


def test_idle_by_range_splits_every_idle_stretch():
    split = program_spans.idle_by_range(events())
    assert split.keys() == WANT.keys()
    for k, v in WANT.items():
        assert split[k] == pytest.approx(v, abs=1e-12), k
    assert sum(split.values()) == pytest.approx(1000e-6 - 515e-6, abs=1e-12)


def test_device_by_range_charges_each_operation_to_its_launchs_ranges():
    split = program_spans.device_by_range(events())
    assert split.keys() == WANT_DEVICE.keys()
    for k, v in WANT_DEVICE.items():
        assert split[k] == pytest.approx(v, abs=1e-12), k
    assert program_spans.device_by_range(events()[1:]) == {}


def test_idle_by_range_without_device_work_or_window():
    split = program_spans.idle_by_range(events(device=False))
    assert sum(split.values()) == pytest.approx(1000e-6, abs=1e-12)
    assert split["wseg.cam.fuse"] == pytest.approx(290e-6, abs=1e-12)
    assert not any(program_spans.device_by_range(events(device=False)).values())
    assert program_spans.idle_by_range(events()[1:]) == {}


def test_chrome_events_of_function_events_split_alike():
    evs = program_spans.chrome_events(FakeTorchProfiler(events()).events())
    assert program_spans.idle_by_range(evs) == pytest.approx(WANT, abs=1e-12)
    assert program_spans.device_by_range(evs) == pytest.approx(WANT_DEVICE, abs=1e-12)


def test_traces_attributes_do_not_see_the_programs_ranges(tmp_path):
    base = {k: v for k, v in UNDER.items() if not k.startswith("wseg.")}
    a, b = trace(tmp_path, events(program=True)), trace(tmp_path, events(program=False), base)
    assert a.busy_s == b.busy_s == pytest.approx(515e-6)
    assert a.window_s == b.window_s
    assert a.gaps == b.gaps and a.top_gaps() == b.top_gaps() and a.top_ops() == b.top_ops()
    assert {n for _, n in a.gaps} <= {"infer", "write", "outside any benchmark span"}
    assert {k: v for k, v in a.device_time_under.items() if k in base} == b.device_time_under


def test_the_new_readers_on_a_synthetic_run(tmp_path, monkeypatch):
    from wseg_tpu_torch.utils import profiling

    spec = Spec()
    prof = FakeTorchProfiler(events())  # noqa: F841 (the idle readers find it on the stack)
    r = run(trace(tmp_path, events()))
    monkeypatch.setitem(profiling.counters, "cam.view_px", 4000)
    monkeypatch.setitem(profiling.counters, "cam.valid_px", 2860)
    got = {m: spec.reader(m)(r) for m in NEW_CAM + ["losses_ms_per_step"]}
    want = {"trunk_ms_per_image": 0.19, "pcm_ms_per_image": None,
            "upsample_fuse_ms_per_image": 0.04, "h2d_ms_per_image": 0.02,
            "bucket_fill_pct": 71.5, "assemble_idle_pct": 11.0, "readback_idle_pct": 21.0,
            "losses_ms_per_step": None}  # no PCM or losses range in this trace
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (None if v is None else pytest.approx(v, rel=1e-9)), k


def test_the_new_readers_report_nothing_without_device_work_or_spans(tmp_path, monkeypatch):
    from wseg_tpu_torch.utils import profiling

    spec = Spec()
    monkeypatch.setitem(profiling.counters, "cam.view_px", 4000)
    monkeypatch.setitem(profiling.counters, "cam.valid_px", 2860)
    prof = FakeTorchProfiler(events(program=False))  # noqa: F841
    base = {k: v for k, v in UNDER.items() if not k.startswith("wseg.")}
    runs = {"untraced": run(None), "cpu": run(trace(tmp_path, events(device=False))),
            "no program spans": run(trace(tmp_path, events(program=False), base))}
    for what, r in runs.items():
        for m in NEW_CAM + ["losses_ms_per_step"]:
            if what == "no program spans" and m == "bucket_fill_pct":
                continue  # the counters are the program's; faked here
            assert spec.reader(m)(r) is None, (what, m)


def test_a_traced_cpu_run_reports_none_of_the_new_metrics(tmp_path):
    evs = events(device=False)
    prof = FakeTorchProfiler(evs)  # noqa: F841
    r = run(trace(tmp_path, evs))
    assert program_spans.idle_pct(r, "wseg.cam.fuse") is None
    assert program_spans.device_s(r, "wseg.model.trunk") is None
