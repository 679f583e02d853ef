"""%: the least time of the batch-statistics BNs' forward in the traced window
(the program's counter "bn.train_bytes", each call's input read once and
its output written once, over HBM's bandwidth), over the device time under
the program's "wseg.bn.train" range. No implementation moves fewer bytes,
so the share cannot pass 100%."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.bn.train")
    if not seconds:
        return None
    try:
        from wseg_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counters
        return None
    nbytes = counters.get("bn.train_bytes", 0)
    return 100.0 * nbytes / seconds / run.peaks["hbm_bytes"] if nbytes else None
