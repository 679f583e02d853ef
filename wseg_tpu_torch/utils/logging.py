"""The stdout tee (on rank 0 of a data-parallel run), meters, a progress
timer, a scalar and image event writer and the eval log writer (the parts
of wseg_tpu/utils/logging.py that the ported CLIs use; reference
tool/pyutils.py and eval.py:89-106). Standard library only, but numpy and
PIL inside `add_image`."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class Logger:
    """Tee stdout to `outfile` (created with its parent directories, written
    anew) while the `with` block runs; leaving the block restores stdout and
    closes the file (reference tool/pyutils.py:6-17, which never does)."""

    def __init__(self, outfile: str):
        self.outfile = outfile

    def __enter__(self):
        os.makedirs(os.path.dirname(self.outfile) or ".", exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(self.outfile, "w")
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.terminal
        self.log.close()

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


@contextlib.contextmanager
def rank_logger(outfile: str | None, group=None):
    """`Logger(outfile)` (stdout as it is if `outfile` is None) on rank 0 of
    a process group or without one; on the other ranks stdout goes nowhere
    while the block runs, so a data-parallel run prints and logs once."""
    if group is None or group.rank() == 0:
        with Logger(outfile) if outfile else contextlib.nullcontext() as log:
            yield log
    else:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            yield None


class AverageMeter:
    """Running means keyed by metric name."""

    def __init__(self):
        self._data: dict[str, list] = {}

    def add(self, values: dict):
        for k, v in values.items():
            acc = self._data.setdefault(k, [0.0, 0])
            acc[0] += float(v)
            acc[1] += 1

    def get(self, *keys: str):
        vals = tuple(self._data[k][0] / max(self._data[k][1], 1) for k in keys)
        return vals[0] if len(vals) == 1 else vals

    def pop(self):
        """Reset every mean."""
        self._data.clear()


class Timer:
    """Wall-clock timer with progress-based ETA and a resettable stage clock."""

    def __init__(self, starting_msg: str | None = None):
        self.start = time.time()
        self.stage_start = self.start
        self.est_finish = self.start
        if starting_msg is not None:
            print(starting_msg, time.ctime(time.time()))

    def update_progress(self, progress: float):
        elapsed = time.time() - self.start
        self.est_finish = int(self.start + elapsed / max(progress, 1e-12))

    def str_est_finish(self) -> str:
        return str(time.ctime(self.est_finish))

    def get_stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self):
        self.stage_start = time.time()


class ScalarWriter:
    """Scalar events as JSON lines in `<logdir>/events.jsonl`, images as pngs
    under `<logdir>/images/` (the JAX package's format, without its optional
    tensorboardX mirror)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._logdir = logdir
        self._path = os.path.join(logdir, "events.jsonl")

    def _write(self, rec: dict):
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def add_scalar(self, tag: str, value, step: int):
        self._write({"t": time.time(), "step": int(step), tag: float(value)})

    def add_scalars(self, main_tag: str, values: dict, step: int):
        rec = {"t": time.time(), "step": int(step)}
        rec.update({f"{main_tag}/{k}": float(v) for k, v in values.items()})
        self._write(rec)

    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC"):
        """An image as `<logdir>/images/<tag>_<step>.png` and an event that
        names it (logging.py:127-160 of the JAX package). `img` is uint8 or a
        [0, 1] float array, HWC or CHW per `dataformats`."""
        import numpy as np
        from PIL import Image

        arr = np.asarray(img)
        if dataformats == "CHW":
            arr = arr.transpose(1, 2, 0)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        img_dir = os.path.join(self._logdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(" ", "_")
        path = os.path.join(img_dir, f"{safe}_{int(step):08d}.png")
        Image.fromarray(arr).save(path)
        self._write({"t": time.time(), "step": int(step), f"image/{tag}": path})


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
