"""%: K1's least time for the window's views at their exact stride-8 sizes
(benchmark/flops.py:pcm_work; the larger of its operations over the dense
TF32 peak and its bytes over HBM's), over the device time of K1's kernels
in the traced window. The kernels' launches, counted by the program
(`pcm_cuda.variant_launches`), must match the trace's."""

import sys

KERNELS = ("pcm_inv_norm_kernel", "pcm_fused_kernel", "pcm_mma_kernel", "pcm_prep_kernel")
LAUNCHED = ("pcm_fused_kernel", "pcm_mma_kernel")  # one of these per launch


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace.kernels if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    seen = sum(1 for name, _ in run.trace.kernels if any(k in name for k in LAUNCHED))
    counted = sum(v for k, v in run.counters.items() if k.startswith("pcm_launches."))
    if seen != counted:
        print(f"pcm_roofline_pct: the trace holds {seen} K1 launches, the program counted "
              f"{counted}; not reported", file=sys.stderr)
        return None
    least = max(run.work["pcm_ops"] / run.peaks["tf32_flops"],
                run.work["pcm_bytes"] / run.peaks["hbm_bytes"])
    return 100.0 * least / seconds
