"""StyleGAN2's StyledConv bodies: modulated 3x3 conv + the whole epilogue
(port of ganecdotes_tpu/ops/modulated_conv_pallas.py).

    out = lrelu(demod * conv3x3(x * s, W) + nw * noise + bias, 0.2) * sqrt(2)

``styled_conv3x3`` (non-up) and ``styled_up_conv3x3`` (2x up, blur composed
into four polyphase 3x3 filters) launch the CUDA kernel of
csrc/styled_conv.cu on CUDA tensors, at every shape, and take their plain
versions only for tensors on the CPU. Plain versions:

* ``styled_conv3x3_ref``: modulate -> conv3x3 -> epilogue;
* ``styled_up_conv3x3_ref``: the sub-pixel form (what the kernel computes);
* ``styled_up_conv3x3_xla``: conv_transpose + demod + blur, the form the
  JAX generator runs by default; the sub-pixel form is held against it.

Arguments: x (B,H,W,Cin) NHWC; w (3,3,Cin,Cout) HWIO, already EqualConv-
scaled; s (B,Cin); demod (B,Cout); noise (1 or B, OH, OW, 1) on the output
grid; noise_weight a scalar tensor; bias (Cout,).
"""

import math

import torch

from ganecdotes_torch.nn.layers import conv2d_nhwc, conv2d_transpose_nhwc
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.subpixel_upconv import (
    compose_up_kernel,
    phase_stack_major,
    upsampled_conv2x_blur,
)
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


def _launch(kernel, x, w_taps, s, demod, noise, noise_weight, bias, up):
    """Checks, modulation and the launch shared by both kernels."""
    for name, t, nd in (("x", x, 4), ("s", s, 2), ("demod", demod, 2),
                        ("noise", noise, 4), ("bias", bias, 1)):
        _build.check_tensor(kernel, t, name, ndim=nd, device=x.device)
    b, h, w, cin = x.shape
    cout = w_taps.shape[-1]
    oh, ow = (2 * h, 2 * w) if up else (h, w)
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
    # the modulation x * s is materialised here, as the JAX kernel does
    xm = x * s[:, None, None, :]
    w_taps = w_taps.contiguous()
    _build.check_tensor(kernel, w_taps, "w", device=x.device)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    noise_bs = 0 if noise.shape[0] == 1 else oh * ow
    _build.launch(
        kernel, "gk_styled_conv3x3",
        _build.ptr(xm), _build.ptr(w_taps), _build.ptr(demod),
        _build.ptr(noise), noise_bs, _build.ptr(noise_weight), _build.ptr(bias),
        _build.ptr(out), b, h, w, cin, cout, int(up), _build.stream_of(x),
    )
    return out


def _check_weight(kernel, w, x):
    _build.check_tensor(kernel, w, "w", ndim=4, device=x.device)
    if tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"{kernel}: w has shape {tuple(w.shape)}, expected (3, 3, {x.shape[3]}, Cout)")


def styled_conv3x3(x, w, s, demod, noise, noise_weight, bias):
    """Non-up StyledConv body: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return styled_conv3x3_ref(x, w, s, demod, noise, noise_weight, bias)
    _check_weight("styled_conv3x3", w, x)
    return _launch("styled_conv3x3", x, w, s, demod, noise, noise_weight,
                   bias, up=False)


def styled_up_conv3x3(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """Upsampling StyledConv body (2x): the CUDA kernel on CUDA tensors, the
    plain sub-pixel version on CPU tensors. The four phase weights come from
    ``compose_up_kernel`` -> ``phase_stack_major``."""
    if x.device.type == "cpu":
        return styled_up_conv3x3_ref(x, w, s, demod, noise, noise_weight,
                                     bias, blur_kernel)
    _check_weight("styled_up_conv3x3", w, x)
    taps = phase_stack_major(compose_up_kernel(w, blur_kernel))
    return _launch("styled_up_conv3x3", x, taps, s, demod, noise,
                   noise_weight, bias, up=True)
