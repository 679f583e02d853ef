"""%: the reference's FLOPs for the window's work at the exact image and crop
shapes (benchmark/flops.py; training forward plus backward), over the
traced window and the card's dense TF32 peak. No method that keeps float32
accuracy can exceed that rate."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.work["flops"] / run.window_s / run.peaks["tf32_flops"]
