"""ms/step: device time under the program's "wseg.seg.backward" range (the
stage-3 step's backward, launched from autograd's thread while the main
thread waits in `loss.backward()`) in the traced window, per step."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.seg.backward")
    return 1e3 * seconds / run.steps if seconds and run.steps else None
