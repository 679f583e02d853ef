"""ms/image: device time under the program's "wseg.model.pcm" range (K1 and
the launches around it at inference) in the traced window, per image."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.model.pcm")
    return 1e3 * seconds / run.images if seconds and run.images else None
