"""StyleGAN2's StyledConv bodies: modulated 3x3 conv + the whole epilogue
(port of ganecdotes_tpu/ops/modulated_conv_pallas.py).

    out = lrelu(demod * conv3x3(x * s, W) + nw * noise + bias, 0.2) * sqrt(2)

``styled_conv3x3`` (non-up) launches the CUDA kernel of csrc/styled_conv.cu:
a 9-tap implicit GEMM on tensor cores in 3xTF32 with the epilogue in
registers; ``styled_up_conv3x3`` (2x up) the two kernels of
csrc/styled_up_conv.cu: the stride-2 transposed conv as a sub-pixel GEMM
with only the 9 taps that see data, on the same main loop
(csrc/tf32x3.cuh), into a scratch tensor, then the blur and the epilogue.
Both run on CUDA tensors at every shape and take their plain versions only
for tensors on the CPU, inside an autograd Function either way. Their
backward is the VJP of the plain composite, as the JAX package's
``_bwd`` and ``_up_bwd`` are (modulated_conv_pallas.py:308-314, :554-561):
``styled_conv3x3_ref`` and ``styled_up_conv3x3_xla``, recomputed from the
saved inputs. It is first order only (``once_differentiable``): a path that
takes gradients of gradients through the generator (PPL) runs the plain
composites instead. Plain versions:

* ``styled_conv3x3_ref``: modulate -> conv3x3 -> epilogue;
* ``styled_up_conv3x3_ref``: the composed sub-pixel form (four 3x3 phase
  filters with the blur folded in);
* ``styled_up_conv3x3_xla``: conv_transpose + demod + blur, the form the
  JAX generator runs by default and the up kernels follow; the sub-pixel
  form is held against it.

Arguments: x (B,H,W,Cin) NHWC; w (3,3,Cin,Cout) HWIO, already EqualConv-
scaled; s (B,Cin); demod (B,Cout); noise (1 or B, OH, OW, 1) on the output
grid; noise_weight a scalar tensor; bias (Cout,).
"""

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ganecdotes_torch.nn.layers import conv2d_nhwc, conv2d_transpose_nhwc
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.subpixel_upconv import upsampled_conv2x_blur
from ganecdotes_torch.ops.upfirdn2d import blur_2d, upfirdn2d_ref

SQRT2 = math.sqrt(2.0)


def _epilogue(out, demod, noise, noise_weight, bias):
    out = out * demod[:, None, None, :].to(out.dtype)
    out = out + noise_weight.to(out.dtype) * noise.to(out.dtype)
    out = out + bias.to(out.dtype)
    return torch.where(out >= 0, out, 0.2 * out) * SQRT2


def styled_conv3x3_ref(x, w, s, demod, noise, noise_weight, bias):
    """Plain version: modulate -> conv3x3 -> demod -> noise -> bias -> lrelu."""
    xm = x * s[:, None, None, :].to(x.dtype)
    return _epilogue(conv2d_nhwc(xm, w, padding=1), demod, noise,
                     noise_weight, bias)


def styled_up_conv3x3_ref(x, w, s, demod, noise, noise_weight, bias,
                          blur_kernel=(1, 3, 3, 1)):
    """Plain version of the up branch in the exact sub-pixel form; noise on
    the fine (2H, 2W) grid."""
    xm = x * s[:, None, None, :].to(x.dtype)
    return _epilogue(upsampled_conv2x_blur(xm, w, blur_kernel), demod, noise,
                     noise_weight, bias)


def styled_up_conv3x3_xla(x, w, s, demod, noise, noise_weight, bias,
                          blur_kernel=(1, 3, 3, 1)):
    """The up branch as conv_transpose + demod + 2-pass blur (same math as
    the sub-pixel form, the JAX generator's default path)."""
    kh = w.shape[0]
    xm = x * s[:, None, None, :].to(x.dtype)
    out = conv2d_transpose_nhwc(xm, w, stride=2)
    out = out * demod[:, None, None, :].to(out.dtype)
    # blur pad for upsample (ref model.py:293-299): p = (len(k)-2)-(ks-1)
    pk = len(blur_kernel) - 2 - (kh - 1)
    out = blur_2d(out, blur_kernel, pad=((pk + 1) // 2 + 1, pk // 2 + 1),
                  upsample_factor=2, impl=upfirdn2d_ref)
    out = out + noise_weight.to(out.dtype) * noise.to(out.dtype)
    out = out + bias.to(out.dtype)
    return torch.where(out >= 0, out, 0.2 * out) * SQRT2


def _check(kernel, x, w, s, demod, noise, noise_weight, bias, up):
    """Checks shared by both kernels; the output's (B, OH, OW, Cout)."""
    for name, t, nd in (("x", x, 4), ("w", w, 4), ("s", s, 2), ("demod", demod, 2),
                        ("noise", noise, 4), ("bias", bias, 1)):
        _build.check_tensor(kernel, t, name, ndim=nd, device=x.device)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    oh, ow = (2 * h, 2 * wd) if up else (h, wd)
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{kernel}: w has shape {tuple(w.shape)}, expected (3, 3, {cin}, Cout)")
    if cin % 4 or cout % 4:
        raise ValueError(f"{kernel}: channels must be multiples of 4, got {cin}->{cout}")
    if tuple(s.shape) != (b, cin):
        raise ValueError(f"{kernel}: s has shape {tuple(s.shape)}, expected {(b, cin)}")
    if tuple(demod.shape) != (b, cout):
        raise ValueError(f"{kernel}: demod has shape {tuple(demod.shape)}, expected {(b, cout)}")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"{kernel}: bias has shape {tuple(bias.shape)}, expected {(cout,)}")
    if noise.shape[0] not in (1, b) or tuple(noise.shape[1:]) != (oh, ow, 1):
        raise ValueError(
            f"{kernel}: noise has shape {tuple(noise.shape)}, expected (1 or {b}, {oh}, {ow}, 1)")
    _build.check_tensor(kernel, noise_weight, "noise_weight", device=x.device)
    if noise_weight.numel() != 1:
        raise ValueError(f"{kernel}: noise_weight must be a scalar")
    return b, oh, ow, cout


def tap_splits(m, cout, sms):
    """How many ways csrc/styled_conv.cu splits its 9 taps (1, 3 or 9) for
    M = m output pixels on ``sms`` SMs. Only a grid of fewer 128 x 128
    tiles than SMs is split, into the fewest waves of whole-K work (the
    smaller split on a tie): a split writes (split, M, Cout) partial sums
    that a second kernel adds up."""
    tiles = -(-m // 128) * -(-cout // 128)
    if tiles >= sms:
        return 1
    return min((1, 3, 9), key=lambda n: -(-tiles * n // sms) / n)


def _conv_forward(x, w, s, demod, noise, noise_weight, bias):
    if x.device.type == "cpu":
        return styled_conv3x3_ref(x, w, s, demod, noise, noise_weight, bias)
    kernel = "styled_conv3x3"
    b, oh, ow, cout = _check(kernel, x, w, s, demod, noise, noise_weight,
                             bias, up=False)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # the modulation x * s is materialised here, as the JAX kernel does
    xm = x * s[:, None, None, :]
    w_nk = w.permute(0, 1, 3, 2).contiguous()  # per tap Cout x Cin, k contiguous
    m = b * oh * ow
    nsplit = tap_splits(m, cout, torch.cuda.get_device_properties(x.device)
                        .multi_processor_count)
    part = None
    if nsplit > 1:
        part = torch.empty((nsplit, m, cout), dtype=x.dtype, device=x.device)
        _build.check_tensor(kernel, part, "scratch")
    _build.launch(
        kernel, "gk_styled_conv3x3",
        _build.ptr(xm), _build.ptr(w_nk), _build.ptr(demod), _build.ptr(noise),
        0 if noise.shape[0] == 1 else oh * ow, _build.ptr(noise_weight),
        _build.ptr(bias), _build.ptr(out),
        None if part is None else _build.ptr(part), nsplit, *x.shape, cout,
        _build.stream_of(x),
    )
    return out


def _blur_taps(kernel, blur_kernel):
    """The separable 1-D taps of ``make_kernel(blur_kernel, gain=4)``:
    2 * k / sum(k), float32."""
    k = np.asarray(blur_kernel, np.float32)
    if k.shape != (4,):
        raise ValueError(f"{kernel}: the kernel takes a 1-D blur of 4 taps, got {blur_kernel}")
    return [float(t) for t in np.float32(2.0) * k / k.sum()]


def _up_conv_forward(x, w, s, demod, noise, noise_weight, bias, blur_kernel):
    if x.device.type == "cpu":
        return styled_up_conv3x3_ref(x, w, s, demod, noise, noise_weight,
                                     bias, blur_kernel)
    kernel = "styled_up_conv3x3"
    taps = _blur_taps(kernel, blur_kernel)
    b, oh, ow, cout = _check(kernel, x, w, s, demod, noise, noise_weight,
                             bias, up=True)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # demod * conv_transpose, (B, 2H+1, 2W+1, Cout), before the blur
    scratch = torch.empty((b, oh + 1, ow + 1, cout), dtype=x.dtype,
                          device=x.device)
    _build.check_tensor(kernel, scratch, "scratch")
    xm = x * s[:, None, None, :]
    w_nk = w.permute(0, 1, 3, 2).contiguous()  # per tap Cout x Cin, k contiguous
    _build.launch(
        kernel, "gk_styled_up_conv3x3",
        _build.ptr(xm), _build.ptr(w_nk), _build.ptr(demod), _build.ptr(noise),
        0 if noise.shape[0] == 1 else oh * ow, _build.ptr(noise_weight),
        _build.ptr(bias), _build.ptr(scratch), _build.ptr(out), *x.shape,
        cout, *taps, _build.stream_of(x),
    )
    return out


def _composite_vjp(ctx, fn, g, *extra):
    """Input gradients of ``fn(*saved, *extra)`` against ``g``, recomputed
    from the saved inputs (only those the caller needs)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = fn(*inputs, *extra)
        grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class _StyledConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, demod, noise, noise_weight, bias):
        ctx.save_for_backward(x, w, s, demod, noise, noise_weight, bias)
        return _conv_forward(x, w, s, demod, noise, noise_weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _composite_vjp(ctx, styled_conv3x3_ref, g)


class _StyledUpConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, demod, noise, noise_weight, bias, blur_kernel):
        ctx.save_for_backward(x, w, s, demod, noise, noise_weight, bias)
        ctx.blur_kernel = blur_kernel
        return _up_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                blur_kernel)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _composite_vjp(ctx, styled_up_conv3x3_xla, g,
                              ctx.blur_kernel) + (None,)


def styled_conv3x3(x, w, s, demod, noise, noise_weight, bias):
    """Non-up StyledConv body: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; first-order differentiable."""
    return _StyledConv3x3.apply(x, w, s, demod, noise, noise_weight, bias)


def styled_up_conv3x3(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """Upsampling StyledConv body (2x): the CUDA kernels on CUDA tensors
    (a 1-D ``blur_kernel`` of 4 taps), the plain sub-pixel version on CPU
    tensors; first-order differentiable."""
    return _StyledUpConv3x3.apply(x, w, s, demod, noise, noise_weight, bias,
                                  tuple(blur_kernel))
