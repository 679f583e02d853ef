"""%: the float32 FLOPs of the dilation-4 convs that K2 ran in the traced
window (the program's counter "conv.dil4_flops", 2 x 9 x CI x CO x B x H x W a
call), over the device time under "wseg.conv.dilated" and the card's float32
peak outside the tensor cores: the convs are bound by operations, and K2's
f32 kernel computes in exact float32 on the CUDA cores."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.conv.dilated")
    if not seconds:
        return None
    try:
        from wseg_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without the counters
        return None
    flops = counters.get("conv.dil4_flops", 0)
    return 100.0 * flops / seconds / run.peaks["f32_flops"] if flops else None
