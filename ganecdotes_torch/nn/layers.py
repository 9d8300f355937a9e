"""NN primitives with StyleGAN2's equalized-lr semantics (port of
ganecdotes_tpu/nn/layers.py).

Weights are stored raw and scaled at use time by the equalized-lr constant,
as the reference does. Layouts follow the JAX package: NHWC activations,
HWIO conv weights, (in, out) linear weights. The NHWC convs run
``F.conv2d`` on a channels-last view, so no layout copy is made.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ganecdotes_torch.ops.fused_act import fused_leaky_relu


def leaky_relu(x, negative_slope=0.2):
    return torch.where(x >= 0, x, x * negative_slope)


def pixel_norm(x, dim=-1, eps=1e-8):
    """x * rsqrt(mean(x**2, channel) + 1e-8) (ref model.py:105-110)."""
    return x * torch.rsqrt(torch.mean(x.square(), dim=dim, keepdim=True) + eps)


class EqualLinear(nn.Module):
    """Equalized linear layer: weight ~ N(0,1)/lr_mul, runtime scale
    (1/sqrt(in))*lr_mul (ref model.py:223-239). Weight (in, out)."""

    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(in_dim, out_dim, generator=generator) / lr_mul
        )
        self.bias = (
            nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        )
        self.lr_mul = lr_mul

    def forward(self, x, activation=None, act=fused_leaky_relu):
        """``activation='fused_lrelu'`` applies ``act`` (the fused bias +
        leaky-ReLU kernel, or its plain version) with the scaled bias."""
        return equal_linear_apply(self, x, self.lr_mul, activation, act)


def equal_linear_apply(p, x, lr_mul=1.0, activation=None, act=fused_leaky_relu):
    in_dim = p.weight.shape[0]
    scale = (1.0 / math.sqrt(in_dim)) * lr_mul
    out = x @ (p.weight.to(x.dtype) * scale)
    bias = p.bias
    if activation == "fused_lrelu":
        return act(out, None if bias is None else bias * lr_mul)
    if bias is not None:
        out = out + (bias * lr_mul).to(out.dtype)
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def conv2d_nhwc(x, w, stride=1, padding=0):
    """Cross-correlation conv (torch F.conv2d semantics), NHWC/HWIO."""
    y = F.conv2d(_nchw(x), _oihw(w).to(x.dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv2d_dilated_nhwc(x, w, dilation=1, padding=0):
    """Atrous conv for the one-shot FCN heads (torch Conv2d(dilation=d))."""
    y = F.conv2d(_nchw(x), _oihw(w).to(x.dtype), padding=padding,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose_nhwc(x, w, stride=2):
    """torch F.conv_transpose2d(stride, padding=0) semantics, NHWC.

    ``w`` is in forward-conv HWIO layout (kh, kw, in, out), the same tensor a
    stride-1 conv would use; conv_transpose2d takes it as (in, out, kh, kw).
    """
    y = F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1).to(x.dtype),
                           stride=stride)
    return y.permute(0, 2, 3, 1)
