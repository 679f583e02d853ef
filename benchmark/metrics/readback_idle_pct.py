"""%: the share of the traced window in which the card was idle while the
host fused an image's CAM and read it back (the program's "wseg.cam.fuse"
range)."""

from benchmark.program_spans import idle_pct


def read(run):
    return idle_pct(run, "wseg.cam.fuse")
