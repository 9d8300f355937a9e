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

A bfloat16 tensor launches the bf16 kernel (counted as ``upfirdn2d_bf16``:
staged as bf16, fp32 passes, one rounding on the store) on a plan of its
own (``plan`` at a 2-byte element); any type but float32 and bfloat16
raises.

Host time: the serving request's to_rgb upsample is a few microseconds of
device work, so the wrapper's own time is the call's. The 2-D kernels of
``upsample_2d`` / ``downsample_2d`` / ``blur_2d``, the ``_Spec`` of each
(kernel, up, down, pad), its adjoint, and the packed launch arguments of
each (spec, shape, element type) are built once and cached.
"""

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ganecdotes_torch.ops import _build

KERNEL = "upfirdn2d"
THREADS = 256  # a block's threads (fewer where the channel slice needs it)
SMEM_MAX = 96 * 1024  # a block's shared memory: at least two blocks an SM
SMEM_MAX_BF16 = 72 * 1024  # the bf16 kernel's: at least three blocks an SM
GRID_MAX = 65535  # the grid's y and z extents
# csrc/upfirdn2d.cu: the bf16 kernel's rows (RV; RV_BLUR at the 4 x 4 blur
# with up = down = 1, its taps known) and columns (CH) a thread
RV, RV_BLUR, CH = 2, 4, 4


def make_kernel(k, gain=1.0):
    """Normalised FIR kernel from 1-D taps: outer(k, k) / sum * gain (numpy)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return k * gain


_MODULE_KERNELS = {}


def _module_kernel(kernel_taps, gain):
    """``make_kernel`` for the modules below, built once per 1-D taps and
    gain (shared: not to be written to)."""
    try:
        key = (tuple(kernel_taps), gain)
        k = _MODULE_KERNELS.get(key)
    except TypeError:  # a 2-D kernel: not cached
        return make_kernel(kernel_taps, gain)
    if k is None:
        k = _MODULE_KERNELS[key] = make_kernel(kernel_taps, gain)
    return k


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
def plan(c, kh, kw, up, down, esize=4):
    """The kernel's tile for C channels, kh x kw taps, (up, down) per axis
    (x, y) and ``esize``-byte elements (4: float32, 2: bf16).

    float32: a 32-channel slice (all of C when it is less), 8 output rows
    and about 512 output (column, channel) pairs a row, halved while the two
    shared buffers exceed ``SMEM_MAX``. (8 rows, not 16: on the H100 the
    discriminator's blurs ran faster with four blocks an SM, which hide the
    staging better than the smaller halo of 16 rows saves.)

    bf16 (``_plan_bf16``): its own."""
    if esize == 2:
        return _plan_bf16(c, kh, kw, up, down)
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


def smem_bf16(ih, iw, toh, ct, vpass):
    """The bf16 kernel's shared memory: the staged bf16 footprint, rounded
    up to 16 bytes, then the fp32 intermediate."""
    return -(-ih * iw * ct * 2 // 16) * 16 + (toh * iw * ct * 4 if vpass else 0)


def _plan_bf16(c, kh, kw, up, down):
    """The bf16 kernel's tile, from ``kernel_ab.py --fir-plans`` on the H100
    (the D blurs and ADA's passes): 8 channels a thread where C % 8 == 0
    (16-byte copies and stores) in a 64-channel slice, 4 output rows and
    128 threads, six blocks an SM whose staging and passes overlap, and the
    fewest output columns (a power of two, 16 or more) whose horizontal
    pass, CH columns a thread, gives every thread a group; 4 channels a
    thread where C % 4 == 0 (ADA's y passes as 4-channel columns), else 1
    (C = 3), in a 32-channel slice (all of C when it is less), 16 and 8 rows
    of 128 columns, 256 threads. Halved while the staged bf16 rows and the
    fp32 intermediate exceed ``SMEM_MAX_BF16``."""
    (up_x, up_y), (down_x, down_y) = up, down
    vec = 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1
    ct, toh, threads = ((min(c, 64), 4, 128) if vec == 8
                        else (min(c, 32), 16 if vec == 4 else 8, THREADS))
    ctv = ct // vec
    threads -= threads % ctv
    vpass = not (kh == 1 and up_y == 1 and down_y == 1)
    groups = -(-threads // (toh * ctv))  # column groups that fill the block
    tow = min(128, max(16, 1 << (CH * groups - 1).bit_length())) if vec == 8 else 128
    while True:
        ih = _extent(toh, kh, up_y, down_y) if vpass else toh
        iw = _extent(tow, kw, up_x, down_x)
        smem = smem_bf16(ih, iw, toh, ct, vpass)
        if smem <= SMEM_MAX_BF16:
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
    (taps_y, taps_x) or None where it is not separable (the kernel's),
    normalised up, down and pad, and a hashable key of all four."""

    kernel: np.ndarray
    taps: Optional[Tuple[np.ndarray, np.ndarray]]
    up: tuple
    down: tuple
    pad: tuple
    key: tuple = ()

    def adjoint(self, in_hw, out_hw):
        """The upfirdn2d whose output is the input gradient: up and down
        swapped, flipped taps, the gradient padding per axis (cached by the
        spec's key and the two sizes)."""
        ck = (self.key, tuple(in_hw), tuple(out_hw))
        adj = _ADJOINTS.get(ck) if self.key else None
        if adj is None:
            (h, w), (oh, ow) = in_hw, out_hw
            kh, kw = self.kernel.shape
            (up_x, up_y), (down_x, down_y), (px0, _, py0, _) = self.up, self.down, self.pad
            pad = (kw - px0 - 1, w * up_x - ow * down_x + px0 - up_x + 1,
                   kh - py0 - 1, h * up_y - oh * down_y + py0 - up_y + 1)
            taps = None if self.taps is None else tuple(
                np.ascontiguousarray(t[::-1]) for t in self.taps)
            kernel = np.ascontiguousarray(self.kernel[::-1, ::-1])
            adj = _Spec(kernel, taps, self.down, self.up, pad,
                        _spec_key(kernel, self.down, self.up, pad))
            if self.key:
                _ADJOINTS[ck] = adj
        return adj


def _spec_key(kernel, up, down, pad):
    return (kernel.shape, kernel.tobytes(), up, down, pad)


_SPECS = {}  # make_spec's, by the 2-D kernel's bytes, up, down, pad, device
_ADJOINTS = {}  # _Spec.adjoint's, by the spec's key and the two sizes
_LAUNCHES = {}  # launch_config's, by the spec's key, shape and element size


def launch_config(shape, out_shape, spec, esize):
    """The (B, H, W, C) views of the input and output the kernel runs on,
    and the arguments of ``gk_upfirdn2d`` between the two pointers and the
    stream, for an input of ``shape`` and ``esize``-byte elements."""
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, _) = spec.up, spec.down, spec.pad
    taps_y, taps_x = spec.taps
    kh, kw = len(taps_y), len(taps_x)
    lb, lh, lw, lc = launch_shape(shape, kw, up_x, down_x, (px0, px1))
    b, oh, ow, c = out_shape
    out_view = (lb, oh, ow * c // lc, lc)
    p = plan(lc, kh, kw, spec.up, spec.down, esize)
    if -(-oh // p.toh) > GRID_MAX or lb * -(-lc // p.ct) > GRID_MAX:
        raise ValueError(f"{KERNEL}: output {tuple(out_shape)} needs a grid over {GRID_MAX}")
    taps = _build.Taps()
    if p.vpass:
        taps.ky[:kh] = taps_y.tolist()
        taps.kx[:kw] = taps_x.tolist()
    else:  # the single vertical tap folded into the horizontal ones
        taps.ky[0] = 1.0
        taps.kx[:kw] = (taps_x * taps_y[0]).tolist()
    taps.kh, taps.kw = kh, kw
    return (lb, lh, lw, lc), out_view, (lb, lh, lw, lc, *out_view[1:3], up_x, up_y, down_x,
                                        down_y, px0, py0, p.toh, p.tow, p.ct, p.ih, p.iw,
                                        p.vec, p.threads, int(p.vpass), taps)


def launch_args(x, y, spec):
    """The views of ``x`` and its output ``y`` the kernel runs on, and the
    arguments of ``gk_upfirdn2d`` between the two pointers and the stream
    (any device: the CPU tests feed them to a mirror of the kernel)."""
    view, out_view, args = launch_config(tuple(x.shape), tuple(y.shape), spec,
                                         x.element_size())
    return x.view(view), y.view(out_view), args


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
    ck = (spec.key, x.shape, dtype)
    hit = _LAUNCHES.get(ck) if spec.key else None
    if hit is None:
        out_shape = output_shape(x.shape, spec)
        args = None
        if math.prod(out_shape):
            args = launch_config(tuple(x.shape), out_shape, spec, x.element_size())[2]
        hit = (out_shape, args)
        if spec.key:
            _LAUNCHES[ck] = hit
    out_shape, args = hit
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if args is not None:  # the views share x's and y's addresses
        _build.launch(kernel, _build.entry("gk_upfirdn2d", dtype), x.data_ptr(),
                      y.data_ptr(), *args, _build.stream_of(x))
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
    """The ``_Spec`` of one upfirdn2d (cached); ``cuda``: raise where the
    kernel cannot run it."""
    if isinstance(kernel, torch.Tensor):
        raise TypeError(f"{KERNEL}: pass the FIR kernel as a host array")
    k = np.asarray(kernel, dtype=np.float32)
    up, down, pad = _normalize_args(up, down, pad)
    ck = (k.shape, k.tobytes(), up, down, pad, cuda)
    spec = _SPECS.get(ck)
    if spec is None:
        spec = _make_spec(k, up, down, pad, cuda)
        _SPECS[ck] = spec
    return spec


def _make_spec(k, up, down, pad, cuda):
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
    k = k.copy()  # the spec is cached: not the caller's array
    return _Spec(k, taps, up, down, pad, _spec_key(k, up, down, pad))


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
    k = _module_kernel(kernel_taps, factor**2)
    p = k.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return impl(x, k, up=factor, down=1, pad=(pad0, pad1))


def downsample_2d(x, kernel_taps=(1, 3, 3, 1), factor=2, impl=upfirdn2d):
    """Downsample module semantics (ref models/stylegan2/model.py:145-163)."""
    k = _module_kernel(kernel_taps, 1.0)
    p = k.shape[0] - factor
    return impl(x, k, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur_2d(x, kernel_taps=(1, 3, 3, 1), pad=(0, 0), upsample_factor=1,
            impl=upfirdn2d):
    """Blur module semantics (ref models/stylegan2/model.py:166-182)."""
    gain = upsample_factor**2 if upsample_factor > 1 else 1.0
    k = _module_kernel(kernel_taps, gain)
    return impl(x, k, up=1, down=1, pad=pad)
