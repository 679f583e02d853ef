"""%: the share of the window the loop spent waiting on the prefetch window
(the benchmark's "input_wait" span around the futures' results)."""


def read(run):
    waits = run.spans.within("input_wait", *run.window)
    return 100.0 * sum(waits) / run.window_s if waits else None
