"""ms/image: device time of the kernels cuDNN's convolutions launch
(`aten::cudnn_convolution`, `aten::convolution_backward`) in the traced
window, per image."""

OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(run):
    if run.trace is None or not run.images:
        return None
    seconds = sum(run.trace.device_time_under.get(op, 0.0) for op in OPS)
    return 1e3 * seconds / run.images if seconds > 0 else None
