"""Progress timer and eval log writer (the parts of wseg_tpu/utils/logging.py
that the ported CLIs use; reference tool/pyutils.py and eval.py:89-106)."""

from __future__ import annotations

import os
import time


class Timer:
    """Wall-clock timer with progress-based ETA."""

    def __init__(self, starting_msg: str | None = None):
        self.start = time.time()
        self.est_finish = self.start
        if starting_msg is not None:
            print(starting_msg, time.ctime(time.time()))

    def update_progress(self, progress: float):
        elapsed = time.time() - self.start
        self.est_finish = int(self.start + elapsed / max(progress, 1e-12))

    def str_est_finish(self) -> str:
        return str(time.ctime(self.est_finish))


def writedict(f, dictionary: dict):
    """One-line `key:value` dump, the reference eval log format."""
    f.write("".join("%s:%s  " % (k, v) for k, v in dictionary.items()) + "\n")


def writelog(filepath: str, metric: dict, comment: str):
    """Append a timestamped metric block."""
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "a") as logfile:
        logfile.write(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()))
        logfile.write("\t%s\n" % comment)
        writedict(logfile, metric)
        logfile.write("=====================================\n")
