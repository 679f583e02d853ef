"""One reader per metric, found by the metric's name in BENCHMARK.json: each
module's `read(run)` returns the value, or None where the run holds nothing
to read."""
