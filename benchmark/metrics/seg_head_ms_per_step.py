"""ms/step: device time under the program's "wseg.seg.head" range (the DeepLab
head's forward: conv_fov, its BN and relu, conv_fov2, its BN and relu,
dropout, cls_conv and the upsample to the crop) in the traced window, per
step."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.seg.head")
    return 1e3 * seconds / run.steps if seconds and run.steps else None
