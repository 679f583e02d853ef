"""s: process start to window start, host clock: imports, the kernels'
build, weights from the seed, the inputs, the warm-up of the cell's shapes
and cuDNN's autotuning where the cell's CLI does it."""


def read(run):
    return run.setup_s
