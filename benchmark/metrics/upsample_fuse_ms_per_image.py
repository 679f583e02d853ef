"""ms/image: device time under the program's "wseg.cam.upsample" and
"wseg.cam.fuse" ranges (each view's crop, resize chain and flip-add; each
image's label mask, fusion and read-back) in the traced window, per
image."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.cam.upsample", "wseg.cam.fuse")
    return 1e3 * seconds / run.images if seconds and run.images else None
