"""s: host clock of set-up's first training step, from its launch to the
synchronize that ends it: cuDNN's choice of algorithms for every conv shape
where the cell's CLI autotunes, the first launches and allocations."""


def read(run):
    return getattr(run.session, "first_step_s", None)
