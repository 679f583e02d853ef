"""ms/step: device time under the program's "wseg.train.losses" range (every
stage-1 loss of the step, forward only) in the traced window, per step."""

from benchmark.program_spans import device_s


def read(run):
    seconds = device_s(run, "wseg.train.losses")
    return 1e3 * seconds / run.steps if seconds and run.steps else None
