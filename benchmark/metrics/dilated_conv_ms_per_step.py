"""ms/step: device time under the program's "wseg.conv.dilated" range (the
forward of each trunk dilation-4 conv that ran on K2's f32 kernel: the
kernel's (3, 3, CI, CO) rows and the kernel itself) in the traced window, per
step."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.conv.dilated")
    return 1e3 * seconds / run.steps if seconds and run.steps else None
