"""ms/step: device time under the profiler's range of the optimizer's step
(`Optimizer.step#PolySGD.step`) in the traced window, per step."""

RANGE = "Optimizer.step#PolySGD.step"


def read(run):
    if run.trace is None or not run.steps:
        return None
    seconds = run.trace.device_time_under.get(RANGE, 0.0)
    return 1e3 * seconds / run.steps if seconds > 0 else None
