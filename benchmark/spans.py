"""The benchmark's own spans: host-clock intervals kept in memory, each also a
`torch.profiler.record_function` range, so a traced run sees them beside
the device's work. Threads may record at once."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

PREFIX = "wsegbench."


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.done: list[tuple[str, float, float]] = []  # (name, start, end), perf_counter s

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.done.append((name, t0, t1))

    def within(self, name: str, t0: float, t1: float) -> list[float]:
        """Durations of the `name` spans that lie wholly inside [t0, t1]."""
        with self._lock:
            return [e - s for n, s, e in self.done if n == name and t0 <= s and e <= t1]

    def totals(self, t0: float, t1: float) -> dict:
        """{name: (count, seconds)} of the spans that lie wholly inside [t0, t1]."""
        out: dict = {}
        with self._lock:
            for n, s, e in self.done:
                if t0 <= s and e <= t1:
                    c, sec = out.get(n, (0, 0.0))
                    out[n] = (c + 1, sec + e - s)
        return out
