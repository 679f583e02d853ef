"""%: the share of the traced window in which the card was idle while the
host assembled a scale's padded batch or copied it to the card (the
program's "wseg.cam.assemble" and "wseg.cam.h2d" ranges)."""

from benchmark.program_spans import idle_pct


def read(run):
    return idle_pct(run, "wseg.cam.assemble", "wseg.cam.h2d")
