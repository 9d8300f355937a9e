"""Fused bias + leaky-ReLU + scale (port of ganecdotes_tpu/ops/fused_act.py).

``fused_leaky_relu_ref`` is the plain PyTorch version; ``fused_leaky_relu``
launches the CUDA kernel (csrc/fused_act.cu) on a CUDA tensor and takes the
plain version only for a tensor on the CPU. Forward only.
"""

import math

import torch

from ganecdotes_torch.ops import _build

KERNEL = "fused_leaky_relu"


def fused_leaky_relu_ref(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    """y = leaky_relu(x + bias) * scale, bias (C,) over the trailing axis."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    """Kernel on a CUDA tensor (float32, contiguous, any (..., C)); the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_leaky_relu_ref(x, bias, negative_slope, scale)
    _build.check_tensor(KERNEL, x, "x")
    c = x.shape[-1] if x.dim() else 1
    if bias is not None:
        _build.check_tensor(KERNEL, bias, "bias", ndim=1, device=x.device)
        if bias.shape[0] != c:
            raise ValueError(f"{KERNEL}: bias has {bias.shape[0]} channels, x has {c}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _build.launch(
        KERNEL, "gk_fused_leaky_relu",
        _build.ptr(x), None if bias is None else _build.ptr(bias), _build.ptr(y),
        x.numel(), c, float(negative_slope), float(scale), _build.stream_of(x),
    )
    return y
