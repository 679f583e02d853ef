"""PyTorch/CUDA port of wseg_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (wseg_tpu.X -> wseg_tpu_torch.X) and
file contracts; tensors are NCHW. Entry points run on the GPU unless the caller
passes device="cpu".
"""
