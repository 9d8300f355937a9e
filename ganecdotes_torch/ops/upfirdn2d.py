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
autograd Function either way. The kernel takes a separable kernel (a
rank-1 2-D kernel, factored into its 1-D taps as the JAX package's
``_separable_taps`` does) of at most ``_build.KMAX`` taps per axis, and up
and down of 1 or 2 per axis. The Function's backward is the same Function
(the gradient algebra of the reference's ``UpFirDn2dBackward``): up and
down swapped, the taps flipped, and per axis the "gradient padding"
``(k - pad0 - 1, in*up - out*down + pad0 - up + 1)``, so every order of
derivative runs on the kernel, as the JAX package's blur backward is the
same Pallas kernel (upfirdn2d_pallas.py:222-242).

A bfloat16 tensor launches the kernel's bf16 instance (counted as
``upfirdn2d_bf16``: fp32 passes, one rounding on the store); any type but
float32 and bfloat16 raises.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ganecdotes_torch.ops import _build

KERNEL = "upfirdn2d"
THREADS = 256  # a block's threads (fewer where the channel slice needs it)
SMEM_MAX = 96 * 1024  # a block's shared memory: at least two blocks an SM
GRID_MAX = 65535  # the grid's y and z extents


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


def _separable_taps(kernel):
    """Recover 1-D taps (ky, kx) if ``kernel`` is an outer product, else None
    (a copy of the JAX package's ``_separable_taps``).

    Kernels from ``make_kernel`` are rank-1 by construction; detected
    numerically so arbitrary kernels still work via the reference path.
    """
    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 2:
        return None
    u, s, vt = np.linalg.svd(k)
    if s.shape[0] > 1 and s[1] > 1e-6 * max(s[0], 1e-30):
        return None
    ky = u[:, 0] * np.sqrt(s[0])
    kx = vt[0] * np.sqrt(s[0])
    # fix sign so taps are predominantly positive (blur kernels are)
    if ky.sum() < 0:
        ky, kx = -ky, -kx
    return tuple(ky.tolist()), tuple(kx.tolist())


@functools.lru_cache(maxsize=None)
def _cached_taps(shape, data):
    taps = _separable_taps(np.frombuffer(data, np.float32).reshape(shape))
    return None if taps is None else tuple(np.asarray(t, np.float32) for t in taps)


def separable_taps(k):
    """``_separable_taps`` of a float32 2-D kernel as float32 arrays, cached
    by its bytes (the discriminator blurs with one kernel some hundred times
    a step)."""
    return _cached_taps(k.shape, k.tobytes())


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


class Plan(NamedTuple):
    """A block of the kernel: toh output rows x tow output columns x ct
    channels, staged from ih input rows x iw input columns; ``vec`` channels
    a thread (4 when C % 4 == 0), ``threads`` a multiple of ct / vec;
    ``vpass`` False for a single tap at up = down = 1 on y, which the
    horizontal taps absorb."""

    toh: int
    tow: int
    ct: int
    ih: int
    iw: int
    vec: int
    threads: int
    vpass: bool
    smem: int


def _extent(n_out, k, up, down):
    """Input samples a run of n_out outputs reads along one axis (at most)."""
    return -(-((n_out - 1) * down + k) // up)


@functools.lru_cache(maxsize=None)
def plan(c, kh, kw, up, down):
    """The kernel's tile for C channels, kh x kw taps and (up, down) per axis
    (x, y): a 32-channel slice (all of C when it is less), 8 output rows and
    about 512 output (column, channel) pairs a row, halved while the two
    shared buffers exceed ``SMEM_MAX``. (8 rows, not 16: on the H100 the
    discriminator's blurs ran faster with four blocks an SM, which hide the
    staging better than the smaller halo of 16 rows saves.)"""
    (up_x, up_y), (down_x, down_y) = up, down
    vec = 4 if c % 4 == 0 else 1
    ct = min(c, 32)
    threads = THREADS - THREADS % (ct // vec)
    vpass = not (kh == 1 and up_y == 1 and down_y == 1)
    toh, tow = 8, min(128, max(16, 1 << ((512 // ct).bit_length() - 1)))
    while True:
        ih = _extent(toh, kh, up_y, down_y) if vpass else toh
        iw = _extent(tow, kw, up_x, down_x)
        smem = (ih * iw + (toh * iw if vpass else 0)) * ct * 4
        if smem <= SMEM_MAX:
            return Plan(toh, tow, ct, ih, iw, vec, threads, vpass, smem)
        if tow >= toh:
            tow //= 2
        else:
            toh //= 2


def launch_shape(shape, kw, up_x, down_x, pad_x):
    """The (B, H, W, C) view the kernel runs on. With a single tap across and
    no up, down or pad on x, each (column, channel) row is filtered down on
    its own, so C % 4 != 0 (ADA's y passes, C = 3) runs as W*C/4 columns of
    4 channels, with 16-byte copies."""
    b, h, w, c = shape
    if kw == 1 and up_x == down_x == 1 and tuple(pad_x) == (0, 0) and c % 4 and w * c % 4 == 0:
        return b, h, w * c // 4, 4
    return tuple(shape)


class _Spec(NamedTuple):
    """One upfirdn2d: the 2-D kernel (the plain version's), its 1-D taps
    (taps_y, taps_x) or None where it is not separable (the kernel's), and
    normalised up, down and pad."""

    kernel: np.ndarray
    taps: Optional[Tuple[np.ndarray, np.ndarray]]
    up: tuple
    down: tuple
    pad: tuple

    def adjoint(self, in_hw, out_hw):
        """The upfirdn2d whose output is the input gradient: up and down
        swapped, flipped taps, the gradient padding per axis."""
        (h, w), (oh, ow) = in_hw, out_hw
        kh, kw = self.kernel.shape
        (up_x, up_y), (down_x, down_y), (px0, _, py0, _) = self.up, self.down, self.pad
        pad = (kw - px0 - 1, w * up_x - ow * down_x + px0 - up_x + 1,
               kh - py0 - 1, h * up_y - oh * down_y + py0 - up_y + 1)
        taps = None if self.taps is None else tuple(
            np.ascontiguousarray(t[::-1]) for t in self.taps)
        return _Spec(np.ascontiguousarray(self.kernel[::-1, ::-1]), taps,
                     self.down, self.up, pad)


def launch_args(x, y, spec):
    """The views of ``x`` and its output ``y`` the kernel runs on, and the
    arguments of ``gk_upfirdn2d`` between the two pointers and the stream
    (any device: the CPU tests feed them to a mirror of the kernel)."""
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, _) = spec.up, spec.down, spec.pad
    taps_y, taps_x = spec.taps
    kh, kw = len(taps_y), len(taps_x)
    lb, lh, lw, lc = launch_shape(x.shape, kw, up_x, down_x, (px0, px1))
    xl, yl = x.view(lb, lh, lw, lc), y.view(lb, y.shape[1], -1, lc)
    p = plan(lc, kh, kw, spec.up, spec.down)
    if -(-yl.shape[1] // p.toh) > GRID_MAX or lb * -(-lc // p.ct) > GRID_MAX:
        raise ValueError(f"{KERNEL}: output {tuple(y.shape)} needs a grid over {GRID_MAX}")
    taps = _build.Taps()
    if p.vpass:
        taps.ky[:kh] = taps_y.tolist()
        taps.kx[:kw] = taps_x.tolist()
    else:  # the single vertical tap folded into the horizontal ones
        taps.ky[0] = 1.0
        taps.kx[:kw] = (taps_x * taps_y[0]).tolist()
    taps.kh, taps.kw = kh, kw
    return xl, yl, (*xl.shape, *yl.shape[1:3], up_x, up_y, down_x, down_y, px0, py0,
                    p.toh, p.tow, p.ct, p.ih, p.iw, p.vec, p.threads, int(p.vpass), taps)


def output_shape(shape, spec):
    """The kernel's (B, OH, OW, C) for an input of ``shape``. Raises for an
    empty output and for one of 2**31 elements or more: the kernel's index
    math is 32-bit, and ``_build.check_tensor`` bounds only the input,
    which an up-2 FIR makes four times larger."""
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, py1) = spec.up, spec.down, spec.pad
    b, h, w, c = shape
    oh = out_size(h, up_y, py0, py1, len(spec.taps[0]), down_y)
    ow = out_size(w, up_x, px0, px1, len(spec.taps[1]), down_x)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"{KERNEL}: empty output {oh}x{ow} for input {tuple(shape)}")
    if b * oh * ow * c >= 2**31:
        raise ValueError(f"{KERNEL}: output {(b, oh, ow, c)} has {b * oh * ow * c} "
                         "elements, over 2**31")
    return b, oh, ow, c


def _forward(x, spec):
    """The kernel's launch (CUDA) or the plain version (CPU)."""
    if x.device.type == "cpu":
        return upfirdn2d_ref(x, spec.kernel, spec.up, spec.down, spec.pad)
    x = x.contiguous()
    dtype = _build.kernel_dtype(KERNEL, x)
    kernel = KERNEL if dtype is torch.float32 else KERNEL + "_bf16"
    _build.check_tensor(kernel, x, "x", ndim=4, dtype=dtype)
    y = torch.empty(output_shape(x.shape, spec), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    xl, yl, args = launch_args(x, y, spec)
    _build.launch(kernel, _build.entry("gk_upfirdn2d", dtype), _build.ptr(xl),
                  _build.ptr(yl), *args, _build.stream_of(x))
    return y


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d as given by a ``_Spec``; its backward is this Function
    again with ``spec.adjoint``, so it has derivatives of any order."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec, ctx.in_hw = spec, x.shape[1:3]
        return _forward(x, spec)

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec.adjoint(ctx.in_hw, g.shape[1:3])
        return _UpFirDn2d.apply(g.contiguous(), spec), None


def make_spec(kernel, up, down, pad, cuda):
    """The ``_Spec`` of one upfirdn2d; ``cuda``: raise where the kernel
    cannot run it."""
    up, down, pad = _normalize_args(up, down, pad)
    if isinstance(kernel, torch.Tensor):
        raise TypeError(f"{KERNEL}: pass the FIR kernel as a host array")
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 2:
        raise ValueError(f"{KERNEL}: kernel must be 2-D, got shape {k.shape}")
    taps = separable_taps(k)
    if cuda:
        if taps is None:
            raise ValueError(f"{KERNEL}: the kernel takes a separable (rank-1) "
                             f"FIR kernel, got a {k.shape} kernel of higher rank")
        if max(k.shape) > _build.KMAX:
            raise ValueError(f"{KERNEL}: at most {_build.KMAX} taps per axis, "
                             f"got {k.shape}")
        if not all(f in (1, 2) for f in up + down):
            raise ValueError(f"{KERNEL}: the kernel takes up and down of 1 or 2, "
                             f"got up {up}, down {down}")
    return _Spec(k, taps, up, down, pad)


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Kernel on a CUDA tensor; plain version on a CPU tensor; differentiable.

    ``kernel`` is a 2-D host array (e.g. from ``make_kernel``). On a CUDA
    tensor it must be separable with at most ``_build.KMAX`` taps per axis,
    and up and down 1 or 2 per axis; its 1-D taps travel to the card by
    value with the launch. The plain version takes any case.
    """
    return _UpFirDn2d.apply(x, make_spec(kernel, up, down, pad,
                                         x.device.type != "cpu"))


def upsample_2d(x, kernel_taps=(1, 3, 3, 1), factor=2, impl=upfirdn2d):
    """Upsample module semantics (ref models/stylegan2/model.py:124-142).

    ``impl`` is ``upfirdn2d`` or its plain version ``upfirdn2d_ref``.
    """
    k = make_kernel(kernel_taps, gain=factor**2)
    p = k.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return impl(x, k, up=factor, down=1, pad=(pad0, pad1))


def downsample_2d(x, kernel_taps=(1, 3, 3, 1), factor=2, impl=upfirdn2d):
    """Downsample module semantics (ref models/stylegan2/model.py:145-163)."""
    k = make_kernel(kernel_taps)
    p = k.shape[0] - factor
    return impl(x, k, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur_2d(x, kernel_taps=(1, 3, 3, 1), pad=(0, 0), upsample_factor=1,
            impl=upfirdn2d):
    """Blur module semantics (ref models/stylegan2/model.py:166-182)."""
    gain = upsample_factor**2 if upsample_factor > 1 else 1.0
    k = make_kernel(kernel_taps, gain=gain)
    return impl(x, k, up=1, down=1, pad=pad)
