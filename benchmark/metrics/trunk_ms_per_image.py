"""ms/image: device time under the program's "wseg.model.trunk" range (the
ResNet-38 trunk of every view's forward) in the traced window, per image."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.model.trunk")
    return 1e3 * seconds / run.images if seconds and run.images else None
