"""GiB: `torch.cuda.max_memory_allocated` over the window, after
`reset_peak_memory_stats` at its start: the batch a user's card holds."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.on_gpu else None
