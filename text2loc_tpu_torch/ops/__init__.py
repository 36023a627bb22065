"""Tensor ops of the port: plain PyTorch versions, dispatch, and the CUDA
kernel wrappers (``cuda_*``)."""
