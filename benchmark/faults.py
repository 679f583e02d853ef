"""Faults planted in the program under test, to show that `correct` catches
them (the CPU tests) and to read what they give at a cell's own size
(calibrate.py): each breaks the timed path underneath the harness."""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def answer_altered():
    """One image's fused CAM of every batch altered where it is made: mirrored
    left to right, as a forgotten flip-back would leave it."""
    from wseg_tpu_torch.infer.cam import CamInferencer

    def make(orig):
        def infer_batch(self, items):
            out = orig(self, items)
            out[0] = np.ascontiguousarray(out[0][:, :, ::-1])
            return out
        return infer_batch

    return _patched(CamInferencer, "infer_batch", make)


def cam_half_batch():
    """Half of each batch left out: those images' CAMs come back empty."""
    from wseg_tpu_torch.infer.cam import CamInferencer

    def make(orig):
        def infer_batch(self, items):
            half = len(items) // 2
            return orig(self, items[:half]) + [np.zeros((20, *it[2]), np.float32)
                                               for it in items[half:]]
        return infer_batch

    return _patched(CamInferencer, "infer_batch", make)


def state_unchanged():
    """A training step that leaves the parameters as they were."""
    from wseg_tpu_torch.train.optim import PolySGD

    return _patched(PolySGD, "step", lambda orig: lambda self, closure=None: None)


def train_half_batch():
    """Half of each batch left out, the loss the mean over the rest."""
    import wseg_tpu_torch.train.contrast as contrast

    def make(orig):
        def make_train_step(*args, **kw):
            step = orig(*args, **kw)

            def half(img, label, us=None):
                n = img.shape[0] // 2
                return step(img[:n], label[:n], us)
            return half
        return make_train_step

    return _patched(contrast, "make_train_step", make)


FAULTS = {"answer_altered": answer_altered, "cam_half_batch": cam_half_batch,
          "state_unchanged": state_unchanged, "train_half_batch": train_half_batch}
