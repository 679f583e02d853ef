"""%: the share of the trunk's dilation-4 conv calls in the traced window
that ran on K2's f32 kernel: the program's counters "conv.dil4_k2" over
"conv.dil4_calls", which count while a profiler records."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    try:
        from wseg_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counters
        return None
    calls = counters.get("conv.dil4_calls", 0)
    return 100.0 * counters.get("conv.dil4_k2", 0) / calls if calls else None
