"""ms/image: device time under the program's "wseg.cam.h2d" range (each
chunk's views and valid sizes copied to the card) in the traced window, per
image."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.cam.h2d")
    return 1e3 * seconds / run.images if seconds and run.images else None
