"""Sub-pixel (polyphase) form of StyleGAN2's upsampling modulated conv
(port of ganecdotes_tpu/ops/subpixel_upconv.py).

The up branch runs conv_transpose(x*s, w, stride=2), demod, then a blur
with the [1,3,3,1] kernel at gain 4. Both stages are linear, so they
compose into one transposed conv with the 6x6 kernel
K = conv_full(flip(w), k4). On the stride-2 lattice only 9 of K's 36 taps
see data per output phase, so the whole thing is FOUR 3x3 convs, one per
output phase, followed by a depth-to-space interleave. This module holds
that form, the plain version ``styled_up_conv3x3_ref`` runs. (The CUDA up
kernels keep conv_transpose and blur apart: csrc/styled_up_conv.cu.)
"""

import torch

from ganecdotes_torch.nn.layers import conv2d_nhwc
from ganecdotes_torch.ops.upfirdn2d import make_kernel


def compose_up_kernel(w, blur_kernel=(1, 3, 3, 1)):
    """(3,3,Cin,Cout) forward-HWIO w -> (6,6,Cin,Cout) composed kernel.

    K[t,u] = sum_{p+r=t, q+s=u} flip(w)[p,q] * k4[r,s]: the cross-correlation
    kernel equal to corr(corr(u, flip(w)), k4) on the zero-stuffed input u.
    k4 carries the blur's gain of factor**2 = 4.
    """
    k4 = make_kernel(blur_kernel, gain=4.0)
    wf = torch.flip(w, (0, 1))
    kh, kw = w.shape[0], w.shape[1]
    n = k4.shape[0]
    K = w.new_zeros((kh + n - 1, kw + n - 1) + tuple(w.shape[2:]))
    for r in range(n):
        for s in range(n):
            K[r : r + kh, s : s + kw] += wf * float(k4[r, s])
    return K


def _phases(K):
    # output pixel (2y+a, 2x+c) reads kernel rows K[(1-a)::2], cols K[:, (1-c)::2]
    return [K[(1 - a) :: 2, (1 - c) :: 2] for a in (0, 1) for c in (0, 1)]


def phase_stack(K):
    """(6,6,Cin,Cout) -> (3,3,Cin,4*Cout) phase kernels, channel block ph = a*2+c."""
    return torch.cat(_phases(K), dim=-1)


def upsampled_conv2x_blur(x, w, blur_kernel=(1, 3, 3, 1)):
    """conv_transpose(x, w, stride=2) then blur(k, pad=(1,1), gain=4), as one
    'same' 3x3 conv with 4*Cout outputs + depth-to-space.

    x (B,H,W,Cin) NHWC; returns (B,2H,2W,Cout).
    """
    b, h, wd, _ = x.shape
    co = w.shape[3]
    ks = phase_stack(compose_up_kernel(w, blur_kernel))
    y = conv2d_nhwc(x, ks, padding=1)  # (B, H, W, 4*Cout)
    y = y.reshape(b, h, wd, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * wd, co)
