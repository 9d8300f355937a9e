"""Kernels 1-4 as ``torch.library`` custom ops, for ``torch.export``.

The wrappers in ``ops/*.py`` launch their kernels through ctypes on raw
pointers, which ``torch.export`` cannot trace. Here each of the four
kernels of the serving program is an op of the ``ganecdotes`` library:

* ``ganecdotes::fused_leaky_relu(x, bias, negative_slope, scale)``;
* ``ganecdotes::upfirdn2d(x, kernel, kernel_shape, up, down, pad)``, the
  2-D FIR kernel flattened to floats (float32 values, exact as doubles);
* ``ganecdotes::styled_conv3x3(x, w, s, demod, noise, noise_weight, bias)``;
* ``ganecdotes::styled_up_conv3x3(..., blur_kernel)``.

Each has a fake implementation (the output's shape, nothing launched), so
a traced program holds the op itself. Its CUDA implementation is the
wrapper's own forward (``fused_act._act``, ``upfirdn2d._forward``,
``modulated_conv._conv_forward`` / ``_up_conv_forward``): the same checks,
variant choice and C entry through ``_build.launch``, which counts the
launch. Its CPU implementation is the plain version. The device of the
tensor picks one, as it picks between a wrapper's two paths; a failed
launch raises.

``LIBRARY`` is ``KERNELS`` with these four through the ops: the op set a
program to export runs on. The live servers keep ``KERNELS``, which launch
the same C entries without the dispatcher: through the ops, the host time
a call is 38-60 us longer and the ffhq-256 request of 8 0.94 ms (3%)
slower on an H100 (``kernel_ab.py --ops-route``, the request where the card
waits on the host). Importing this module registers the ops;
a loaded program needs them registered before it runs
(``runtime.export.load_exported`` imports it).
"""

import math
from typing import List, Optional

import numpy as np
import torch

from ganecdotes_torch.ops import fused_act, modulated_conv
from ganecdotes_torch.ops import upfirdn2d as fir
from ganecdotes_torch.ops.opset import KERNELS

Tensor = torch.Tensor
SQRT2 = math.sqrt(2.0)


@torch.library.custom_op("ganecdotes::fused_leaky_relu", mutates_args=(),
                         device_types="cuda")
def _fused_leaky_relu(x: Tensor, bias: Optional[Tensor], negative_slope: float,
                      scale: float) -> Tensor:
    return fused_act._act(x, bias, None, negative_slope, scale)


@_fused_leaky_relu.register_kernel("cpu")
def _(x, bias, negative_slope, scale):
    return fused_act.fused_leaky_relu_ref(x, bias, negative_slope, scale)


@_fused_leaky_relu.register_fake
def _(x, bias, negative_slope, scale):
    return torch.empty_like(x)


def _kernel_2d(kernel, kernel_shape):
    return np.asarray(kernel, np.float32).reshape(kernel_shape)


@torch.library.custom_op("ganecdotes::upfirdn2d", mutates_args=(),
                         device_types="cuda")
def _upfirdn2d(x: Tensor, kernel: List[float], kernel_shape: List[int],
               up: List[int], down: List[int], pad: List[int]) -> Tensor:
    return fir._forward(x, fir.make_spec(_kernel_2d(kernel, kernel_shape), up,
                                         down, pad, True))


@_upfirdn2d.register_kernel("cpu")
def _(x, kernel, kernel_shape, up, down, pad):
    return fir.upfirdn2d_ref(x, _kernel_2d(kernel, kernel_shape), up, down, pad)


@_upfirdn2d.register_fake
def _(x, kernel, kernel_shape, up, down, pad):
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, py1) = up, down, pad
    kh, kw = kernel_shape
    b, h, w, c = x.shape
    return x.new_empty((b, fir.out_size(h, up_y, py0, py1, kh, down_y),
                        fir.out_size(w, up_x, px0, px1, kw, down_x), c))


@torch.library.custom_op("ganecdotes::styled_conv3x3", mutates_args=(),
                         device_types="cuda")
def _styled_conv3x3(x: Tensor, w: Tensor, s: Tensor, demod: Tensor,
                    noise: Tensor, noise_weight: Tensor, bias: Tensor) -> Tensor:
    return modulated_conv._conv_forward(x, w, s, demod, noise, noise_weight, bias)


@_styled_conv3x3.register_kernel("cpu")
def _(x, w, s, demod, noise, noise_weight, bias):
    return modulated_conv.styled_conv3x3_ref(x, w, s, demod, noise,
                                             noise_weight, bias)


@_styled_conv3x3.register_fake
def _(x, w, s, demod, noise, noise_weight, bias):
    b, h, wd, _ = x.shape
    return x.new_empty((b, h, wd, w.shape[3]))


@torch.library.custom_op("ganecdotes::styled_up_conv3x3", mutates_args=(),
                         device_types="cuda")
def _styled_up_conv3x3(x: Tensor, w: Tensor, s: Tensor, demod: Tensor,
                       noise: Tensor, noise_weight: Tensor, bias: Tensor,
                       blur_kernel: List[float]) -> Tensor:
    return modulated_conv._up_conv_forward(x, w, s, demod, noise, noise_weight,
                                           bias, tuple(blur_kernel))


@_styled_up_conv3x3.register_kernel("cpu")
def _(x, w, s, demod, noise, noise_weight, bias, blur_kernel):
    return modulated_conv.styled_up_conv3x3_ref(x, w, s, demod, noise,
                                                noise_weight, bias,
                                                tuple(blur_kernel))


@_styled_up_conv3x3.register_fake
def _(x, w, s, demod, noise, noise_weight, bias, blur_kernel):
    b, h, wd, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * wd, w.shape[3]))


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=SQRT2):
    """``ops.fused_act.fused_leaky_relu`` through its custom op (no
    gradient); the bias cast to x's type, as the wrapper casts it."""
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return torch.ops.ganecdotes.fused_leaky_relu(x, bias, float(negative_slope),
                                                 float(scale))


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """``ops.upfirdn2d.upfirdn2d`` through its custom op (no gradient)."""
    up, down, pad = fir._normalize_args(up, down, pad)
    k = np.asarray(kernel, np.float32)
    return torch.ops.ganecdotes.upfirdn2d(x, k.ravel().tolist(), list(k.shape),
                                          list(up), list(down), list(pad))


def styled_conv3x3(x, w, s, demod, noise, noise_weight, bias):
    """``ops.modulated_conv.styled_conv3x3`` through its custom op (no
    gradient)."""
    return torch.ops.ganecdotes.styled_conv3x3(x, w, s, demod, noise,
                                               noise_weight, bias)


def styled_up_conv3x3(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """``ops.modulated_conv.styled_up_conv3x3`` through its custom op (no
    gradient)."""
    return torch.ops.ganecdotes.styled_up_conv3x3(
        x, w, s, demod, noise, noise_weight, bias,
        [float(t) for t in blur_kernel])


LIBRARY = KERNELS._replace(fused_leaky_relu=fused_leaky_relu, upfirdn2d=upfirdn2d,
                           styled_conv3x3=styled_conv3x3,
                           styled_up_conv3x3=styled_up_conv3x3)
