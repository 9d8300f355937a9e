"""The port's kernels (CUDA, csrc/) and their plain PyTorch versions."""
