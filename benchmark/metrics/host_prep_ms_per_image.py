"""ms/image: the mean of the benchmark's "host_prep" span around the
dataset's `__getitem__` on the prefetch threads (decode, four bicubic
resizes, flips, normalisation), over the images whose preparation began and
ended inside the window."""


def read(run):
    preps = run.spans.within("host_prep", *run.window)
    return 1e3 * sum(preps) / len(preps) if preps else None
