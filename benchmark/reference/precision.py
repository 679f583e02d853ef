"""How the reference runs on the card."""

import contextlib

import torch


@contextlib.contextmanager
def reference_precision(tf32: bool = False):
    """float32, TF32 off (`tf32` on: the control's precision), and PyTorch's
    own convolutions instead of cuDNN's: im2col and a GEMM, so no algorithm
    choice of cuDNN's enters the reference, and faster than cuDNN's float32
    heuristics on the trunk's dilated convolutions."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
