"""%: the share of the gradients that the trunk's dilation-4 convs on K2
were asked for in the traced window (input and weight, each counted) that
K2's f32 design computed, the others going to cuDNN: the program's counters
"conv.dil4_bwd_k2" over "conv.dil4_bwd_grads", which count while a profiler
records. None for a program without them."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    try:
        from wseg_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counters
        return None
    grads = counters.get("conv.dil4_bwd_grads", 0)
    return 100.0 * counters.get("conv.dil4_bwd_k2", 0) / grads if grads else None
