"""Fused bias + leaky-ReLU + scale and its backward (port of
ganecdotes_tpu/ops/fused_act.py ``fused_leaky_relu_pallas`` with its
custom_vjp backward ``_flr_bwd``).

``fused_leaky_relu_ref`` is the plain PyTorch version of the forward and
``fused_leaky_relu_bwd_ref`` that of the backward, ``_flr_bwd`` in torch
ops: ``dx = where(y >= 0, g, g * slope) * scale``, ``db`` the sum of dx
over the rows. ``fused_leaky_relu`` and ``fused_leaky_relu_bwd`` launch the
CUDA kernels of csrc/fused_act.cu on CUDA tensors and take the plain
versions only for tensors on the CPU.

Two autograd Functions, each the other's backward, give every order of
derivative on the kernels (R1 and WGAN-GP differentiate the discriminator
twice):

* ``_Act(x, bias, mask)``: y = lrelu(x + bias) * scale, the sign taken from
  x + bias, or from ``mask`` where one is given. Its VJP is ``_ActGrad`` of
  the cotangent with the saved sign source: y itself (the sign of y is that
  of x + bias), or ``mask``.
* ``_ActGrad(g, s)``: (dx, db) as above with the signs of ``s``. It is
  linear in g, and its VJP given (gdx, gdb) is ``_Act(gdx, gdb, mask=s)``:
  (gdx + gdb[c]) * (s >= 0 ? 1 : slope) * scale, the forward kernel with
  gdb as the bias. Nothing flows to ``s``: the mask is piecewise constant,
  as JAX finds when it differentiates ``_flr_bwd``.

Where there is no gradient to record (inference, or a backward pass
without ``create_graph``) the kernels launch without a Function around
them: on small tensors the Function's host time is most of a call's. Only
y is saved, which the next layer keeps alive anyway. The kernels'
launch is planned here (``plan``): a block of (tx, ty) threads, each
thread one group of ``vec`` channels (4 where C % 4 == 0) walking rows; gx
blocks stride over the rows, gy cover a row wider than tx groups. The
backward's bias gradient sums each block's rows into one row of a (gx, C)
workspace, then each column in a fixed order: the same bits every run.

bfloat16 tensors launch the kernels' bf16 instances (counted as
``fused_leaky_relu_bf16`` and ``fused_leaky_relu_bwd_bf16``): fp32 math,
one rounding on the store, db summed in fp32. The bias is cast to x's type
first, as the plain version casts it. Every tensor of a launch has one
type; any type but float32 and bfloat16 raises.
"""

import functools
import math
from typing import NamedTuple

import torch

from ganecdotes_torch.ops import _build

KERNEL = "fused_leaky_relu"
KERNEL_BWD = "fused_leaky_relu_bwd"
THREADS = 256  # a block's most threads (csrc/fused_act.cu THREADS)
SM_THREADS = 2048  # an SM's most resident threads
GRID_MAX = 65535  # the grid's y extent


def fused_leaky_relu_ref(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    """y = leaky_relu(x + bias) * scale, bias (C,) over the trailing axis."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def fused_leaky_relu_bwd_ref(g, y, with_db=True, negative_slope=0.2,
                             scale=math.sqrt(2.0)):
    """The JAX package's ``_flr_bwd``: (dx, db), db (C,) the sum of dx over
    every axis but the last (None without ``with_db``)."""
    dx = torch.where(y >= 0, g, g * negative_slope) * scale
    return dx, (dx.reshape(-1, dx.shape[-1] if dx.dim() else 1).sum(0)
                if with_db else None)


class Plan(NamedTuple):
    """Both kernels' launch: ``vec`` channels a thread, a (tx, ty) block, a
    (gx, gy) grid. Thread (i, j) of block (bx, by) owns channels
    [vec*q, vec*q + vec), q = by*tx + i, q*vec < C, and rows bx*ty + j +
    k*gx*ty, k = 0, 1, ..."""

    vec: int
    tx: int
    ty: int
    gx: int
    gy: int


@functools.lru_cache(maxsize=1024)
def plan(rows, c, sms):
    """The launch for ``rows`` rows of ``c`` channels on ``sms`` SMs: as
    many row blocks as the card holds at once (at most ``rows``)."""
    vec = 4 if c % 4 == 0 else 1
    groups = c // vec
    tx = min(groups, THREADS)
    ty = THREADS // tx
    gy = -(-groups // tx)
    resident = max(1, sms * (SM_THREADS // (tx * ty)) // gy)
    return Plan(vec, tx, ty, min(-(-rows // ty), resident), gy)


@functools.lru_cache(maxsize=None)
def sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(kernel, t, name, device=None, shape=None, dtype=torch.float32):
    """``_build.check_tensor``'s checks, the common case in one test."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda and t.dtype is dtype
            and t.is_contiguous() and t.data_ptr() % 16 == 0 and t.numel() < 2**31
            and (device is None or t.device == device)):
        _build.check_tensor(kernel, t, name, device=device, dtype=dtype)
    if shape is not None and t.shape != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def launch_plan(kernel, t, sms):
    """(rows, C, plan) of a launch on ``t`` on a card of ``sms`` SMs."""
    c = t.shape[-1] if t.dim() else 1
    rows = t.numel() // c
    p = plan(rows, c, sms)
    if p.gy > GRID_MAX:
        raise ValueError(f"{kernel}: {c} channels, at most {GRID_MAX * THREADS * p.vec}")
    if rows + p.gx * p.ty >= 2**31:  # the kernels step a 32-bit row index
        raise ValueError(f"{kernel}: {rows} rows, under {2**31 - p.gx * p.ty}")
    return rows, c, p


def _act(x, bias, mask, negative_slope, scale):
    """The forward, signs from x + bias or from ``mask``."""
    if x.device.type == "cpu":
        if mask is None:
            return fused_leaky_relu_ref(x, bias, negative_slope, scale)
        v = x if bias is None else x + bias.to(x.dtype)
        return torch.where(mask >= 0, v, v * negative_slope) * scale
    dtype = _build.kernel_dtype(KERNEL, x)
    kernel = KERNEL if dtype is torch.float32 else KERNEL + "_bf16"
    _check(kernel, x, "x", dtype=dtype)
    c = x.shape[-1] if x.dim() else 1
    if bias is not None:
        _check(kernel, bias, "bias", x.device, (c,), dtype)
    if mask is not None:
        _check(kernel, mask, "mask", x.device, x.shape, dtype)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rows, c, p = launch_plan(kernel, x, sm_count(x.device.index))
    _build.launch(kernel, _build.entry("gk_fused_leaky_relu", dtype), x.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  None if mask is None else mask.data_ptr(), y.data_ptr(), rows, c,
                  negative_slope, scale, *p, _build.stream_of(x))
    return y


def _act_grad(g, s, with_db, negative_slope, scale):
    """(dx, db or None), signs from ``s``."""
    if g.device.type == "cpu":
        return fused_leaky_relu_bwd_ref(g, s, with_db, negative_slope, scale)
    dtype = _build.kernel_dtype(KERNEL_BWD, g, "g")
    kernel = KERNEL_BWD if dtype is torch.float32 else KERNEL_BWD + "_bf16"
    _check(kernel, g, "g", dtype=dtype)
    _check(kernel, s, "y", g.device, g.shape, dtype)
    c = g.shape[-1] if g.dim() else 1
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx, g.new_zeros(c) if with_db else None
    rows, c, p = launch_plan(kernel, g, sm_count(g.device.index))
    part = db = None
    if with_db:  # the partial sums stay float32 for either type
        part = torch.empty((p.gx, c), dtype=torch.float32, device=g.device)
        db = torch.empty(c, dtype=g.dtype, device=g.device)
    _build.launch(kernel, _build.entry("gk_fused_leaky_relu_bwd", dtype), g.data_ptr(), s.data_ptr(),
                  dx.data_ptr(), None if part is None else part.data_ptr(),
                  None if db is None else db.data_ptr(), rows, c, negative_slope,
                  scale, *p, _build.stream_of(g))
    return dx, db


def _recorded_act(x, bias, mask, negative_slope, scale):
    """``_act``, inside the autograd Function only where there is a gradient
    to record (its host time matters on small tensors)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or (bias is not None and bias.requires_grad)):
        return _Act.apply(x, bias, mask, negative_slope, scale)
    return _act(x, bias, mask, negative_slope, scale)


def _recorded_act_grad(g, s, with_db, negative_slope, scale):
    """``_act_grad``, inside the autograd Function only where there is a
    gradient to record (a backward without ``create_graph`` records none)."""
    if torch.is_grad_enabled() and g.requires_grad:
        out = _ActGrad.apply(g, s, with_db, negative_slope, scale)
        return out if with_db else (out, None)
    return _act_grad(g, s, with_db, negative_slope, scale)


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, mask, negative_slope, scale):
        y = _act(x, bias, mask, negative_slope, scale)
        ctx.save_for_backward(y if mask is None else mask)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        ctx.has_bias = bias is not None
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None
        (s,) = ctx.saved_tensors
        with_db = ctx.has_bias and ctx.needs_input_grad[1]
        dx, db = _recorded_act_grad(g.contiguous(), s, with_db, ctx.negative_slope,
                                    ctx.scale)
        return dx, db, None, None, None


class _ActGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, s, with_db, negative_slope, scale):
        dx, db = _act_grad(g, s, with_db, negative_slope, scale)
        ctx.save_for_backward(s)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        ctx.set_materialize_grads(False)
        return (dx, db) if with_db else dx

    @staticmethod
    def backward(ctx, gdx, gdb=None):
        if gdx is None and gdb is None:
            return None, None, None, None, None
        (s,) = ctx.saved_tensors
        gdx = torch.zeros_like(s) if gdx is None else gdx.contiguous()
        return (_recorded_act(gdx, gdb, s, ctx.negative_slope, ctx.scale),
                None, None, None, None)


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    """Kernel on a CUDA tensor (float32 or bfloat16, contiguous, any (...,
    C); the bias cast to x's type); the plain version on a CPU tensor.
    Differentiable to any order."""
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return _recorded_act(x, bias, None, float(negative_slope), float(scale))


def fused_leaky_relu_bwd(g, y, with_db=True, negative_slope=0.2, scale=math.sqrt(2.0)):
    """The backward: (dx, db), db None without ``with_db``; kernels on CUDA
    tensors (float32 or bfloat16, one type, contiguous, equal shapes), the
    plain version on CPU
    tensors. Differentiable to any order in ``g``."""
    return _recorded_act_grad(g, y, bool(with_db), float(negative_slope), float(scale))
