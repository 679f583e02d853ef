"""The benchmark of wseg_tpu_torch, the PyTorch and CUDA port: one command
(`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`) runs one cell of BENCHMARK.json on the GPU and prints its metrics and
whether the work it timed was correct. Cells, configurations, drivers and
metrics are files of their own under this directory, found by name."""
