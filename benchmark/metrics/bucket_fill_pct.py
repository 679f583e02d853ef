"""%: the views' true pixels over the pixels the trunk ran, padding
included, in the traced window: the program's counters "cam.valid_px" and
"cam.view_px", which count while a profiler records."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    try:
        from wseg_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counters
        return None
    view = counters.get("cam.view_px", 0)
    return 100.0 * counters.get("cam.valid_px", 0) / view if view else None
