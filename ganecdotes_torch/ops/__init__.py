"""Kernels of the serving path (CUDA, csrc/) and their plain PyTorch versions."""
