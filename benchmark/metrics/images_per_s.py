"""images/s: the window's images (CAM dicts written, or batch x steps
completed) over the whole window, host clock."""


def read(run):
    return run.images / run.window_s
