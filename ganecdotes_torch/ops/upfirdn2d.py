"""upfirdn2d — upsample, FIR filter, downsample (port of
ganecdotes_tpu/ops/upfirdn2d.py).

Semantics, as in the reference CUDA op StyleGAN2 ships with:

    1. zero-insertion upsample by ``up`` (each sample followed by up-1 zeros)
    2. zero padding by (pad0, pad1) per spatial dim (negative pad = crop)
    3. 2-D convolution with ``kernel`` (true convolution: the
       cross-correlation uses the flipped kernel)
    4. subsample by ``down`` starting at index 0

    out_h = (in_h*up + pad0 + pad1 - kh)//down + 1   (same for w)

Pad order is the reference's (x0, x1, y0, y1). All functions are NHWC.
``upfirdn2d_ref`` is the plain PyTorch version (a depthwise conv);
``upfirdn2d`` launches the CUDA kernel (csrc/upfirdn2d.cu) on a CUDA tensor
and takes the plain version only for a tensor on the CPU, inside one
autograd Function either way. Its backward (the gradient algebra of the
reference's ``UpFirDn2dBackward``): flipped taps and the "gradient padding"
``k - pad0 - 1`` and ``in*up - out + pad0 - up + 1`` per axis. For the blur
(up = 1) that is the same Function again, as the JAX package's backward is
the same Pallas kernel (upfirdn2d_pallas.py:222-242), so it has derivatives
of any order; for up = 2 it is the plain down-2 FIR in torch ops, which
autograd differentiates further.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ganecdotes_torch.ops import _build

KERNEL = "upfirdn2d"


def make_kernel(k, gain=1.0):
    """Normalised FIR kernel from 1-D taps: outer(k, k) / sum * gain (numpy)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return k * gain


def _normalize_args(up, down, pad):
    if not isinstance(up, (tuple, list)):
        up = (up, up)
    if not isinstance(down, (tuple, list)):
        down = (down, down)
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    # pad order follows the reference: (x0, x1, y0, y1)
    return tuple(up), tuple(down), tuple(pad)


def out_size(n, up, pad0, pad1, k, down):
    return (n * up + pad0 + pad1 - k) // down + 1


def upfirdn2d_ref(x, kernel, up=1, down=1, pad=(0, 0)):
    """Plain PyTorch version: zero insertion, F.pad, depthwise F.conv2d."""
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, py1) = _normalize_args(
        up, down, pad
    )
    b, h, w, c = x.shape
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    kh, kw = k.shape
    xn = x.permute(0, 3, 1, 2)
    if up_x > 1 or up_y > 1:
        # torch-style insertion: up-1 zeros after every sample, the last too
        xu = xn.new_zeros(b, c, h * up_y, w * up_x)
        xu[:, :, ::up_y, ::up_x] = xn
        xn = xu
    xn = F.pad(xn, [px0, px1, py0, py1])  # negative pads crop
    weight = torch.flip(k, (0, 1)).to(x.dtype).expand(c, 1, kh, kw)
    y = F.conv2d(xn, weight, stride=(down_y, down_x), groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def _forward(x, k, up, pad):
    """The kernel's launch (CUDA) or the plain version (CPU), down = 1."""
    (up_x, up_y), (px0, px1, py0, py1) = up, pad
    if x.device.type == "cpu":
        return upfirdn2d_ref(x, k, up, 1, pad)
    _build.check_tensor(KERNEL, x, "x", ndim=4)
    b, h, w, c = x.shape
    kh, kw = k.shape
    oh = out_size(h, up_y, py0, py1, kh, 1)
    ow = out_size(w, up_x, px0, px1, kw, 1)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"{KERNEL}: empty output {oh}x{ow} for input {tuple(x.shape)}")
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    taps = _build.Taps()
    taps.k[: kh * kw] = k.ravel().tolist()
    _build.launch(
        KERNEL, "gk_upfirdn2d", _build.ptr(x), _build.ptr(y),
        b, h, w, c, oh, ow, up_x, up_y, px0, py0,
        taps, kh, kw, _build.stream_of(x),
    )
    return y


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d at down = 1; ``k`` a float32 host array, ``up`` and ``pad``
    normalised tuples (x and y)."""

    @staticmethod
    def forward(ctx, x, k, up, pad):
        ctx.k, ctx.up, ctx.pad, ctx.in_hw = k, up, pad, x.shape[1:3]
        return _forward(x, k, up, pad)

    @staticmethod
    def backward(ctx, g):
        (up_x, up_y), (px0, _, py0, _) = ctx.up, ctx.pad
        kh, kw = ctx.k.shape
        (h, w), (oh, ow) = ctx.in_hw, g.shape[1:3]
        gpad = (kw - px0 - 1, w * up_x - ow + px0 - up_x + 1,
                kh - py0 - 1, h * up_y - oh + py0 - up_y + 1)
        kf = np.ascontiguousarray(ctx.k[::-1, ::-1])
        if ctx.up == (1, 1):
            return _UpFirDn2d.apply(g.contiguous(), kf, (1, 1), gpad), None, None, None
        return upfirdn2d_ref(g, kf, 1, ctx.up, gpad), None, None, None


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Kernel on a CUDA tensor; plain version on a CPU tensor; differentiable.

    ``kernel`` is a host array (e.g. from ``make_kernel``) of side <= 8; its
    taps travel to the card by value with the launch. The kernel takes
    up 1 or 2 per axis and down = 1: the subsampling passes (the
    discriminator's strided convs follow a blur; ADA's wavelet passes) call
    ``upfirdn2d_ref``.
    """
    up, down, pad = _normalize_args(up, down, pad)
    if isinstance(kernel, torch.Tensor):
        raise TypeError(f"{KERNEL}: pass the FIR kernel as a host array")
    k = np.asarray(kernel, dtype=np.float32)
    kernel_case = (k.ndim == 2 and 1 <= k.shape[0] <= _build.KMAX
                   and 1 <= k.shape[1] <= _build.KMAX)
    if kernel_case and (up[0] not in (1, 2) or up[1] not in (1, 2) or down != (1, 1)):
        kernel_case = False
    if not kernel_case:
        if x.device.type == "cpu":  # the plain version takes any case
            return upfirdn2d_ref(x, k, up, down, pad)
        if k.ndim != 2 or max(k.shape) > _build.KMAX:
            raise ValueError(f"{KERNEL}: kernel must be 2-D with sides <= {_build.KMAX}, got {k.shape}")
        raise ValueError(f"{KERNEL}: the kernel takes up 1 or 2 and down 1, "
                         f"got up {up}, down {down}")
    return _UpFirDn2d.apply(x, k, up, pad)


def upsample_2d(x, kernel_taps=(1, 3, 3, 1), factor=2, impl=upfirdn2d):
    """Upsample module semantics (ref models/stylegan2/model.py:124-142).

    ``impl`` is ``upfirdn2d`` or its plain version ``upfirdn2d_ref``.
    """
    k = make_kernel(kernel_taps, gain=factor**2)
    p = k.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return impl(x, k, up=factor, down=1, pad=(pad0, pad1))


def downsample_2d(x, kernel_taps=(1, 3, 3, 1), factor=2):
    """Downsample module semantics (ref models/stylegan2/model.py:145-163),
    plain: no kernel subsamples."""
    k = make_kernel(kernel_taps)
    p = k.shape[0] - factor
    return upfirdn2d_ref(x, k, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur_2d(x, kernel_taps=(1, 3, 3, 1), pad=(0, 0), upsample_factor=1,
            impl=upfirdn2d):
    """Blur module semantics (ref models/stylegan2/model.py:166-182)."""
    gain = upsample_factor**2 if upsample_factor > 1 else 1.0
    k = make_kernel(kernel_taps, gain=gain)
    return impl(x, k, up=1, down=1, pad=pad)
