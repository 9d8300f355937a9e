"""ADA's 1-D warp pass and its exact adjoint (port of
ganecdotes_tpu/ops/affine_warp_pallas.py ``resample_rows`` and
``resample_rows_t``).

``resample_rows(x, alpha, intercept, out_len)`` resamples (B, C, S, W)
``x`` along S: output row v of column w reads source position
``alpha[b]*v + intercept[b, w]`` with bilinear weights, zero outside
[0, S-1]; ``resample_rows_t(g, alpha, intercept, src_len)`` is its adjoint.
Both launch the CUDA kernels of csrc/affine_warp.cu on CUDA tensors and
take the plain versions (``ops/affine_warp.py::_resample_pass`` and
``_resample_pass_t``) only for tensors on the CPU.

The pass is linear in the image, so each op is the other's VJP: two
autograd Functions whose backwards call each other, which gives
derivatives of every order with respect to the image (R1 takes gradients
of gradients through ADA). The cotangents of ``alpha`` and ``intercept``
are None, as the JAX kernel returns zeros for them: ADA's transform is
drawn, never differentiated.

A bfloat16 image (or cotangent) launches the kernels' bf16 instances
(counted as ``resample_rows_bf16`` / ``resample_rows_t_bf16``; alpha and
the intercepts stay float32, the lerp and the sums run in fp32 and round
once on the store): each a kernel of its own reading a band of rows
staged in shared memory, the forward 8 consecutive columns of an output
row a thread (``forward_plan``), the adjoint 8 consecutive rows of a
column of dx a thread, walking the cotangent's rows once
(``adjoint_plan``); any other type but float32 raises.
"""

import torch

from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.affine_warp import _resample_pass, _resample_pass_t


def resample_rows_ref(x, alpha, intercept, out_len):
    """Plain version: ``_resample_pass`` along rows."""
    return _resample_pass(x, alpha, intercept, axis=2, out_len=out_len)


def resample_rows_t_ref(g, alpha, intercept, src_len):
    """Plain version of the adjoint: ``_resample_pass_t``."""
    return _resample_pass_t(g, alpha, intercept, src_len)


GRID_MAX = 65535  # the grid's y and z extents
FWD_BLOCK = (32, 8)  # the forward's block: 32 columns w (one warp) x 8 rows v
ADJ_ROWS = 8  # the float32 adjoint's block rows (its columns as FWD_BLOCK's)
# csrc/affine_warp.cu: the bf16 forward's tile (BF_TW columns x BF_TV rows),
# the consecutive columns a thread (BF_NW) and the staged band's bytes
BF16_TILE = (32, 32)
BF16_COLUMNS = 8
BAND_SMEM = 16 * 1024
# the bf16 adjoint's tile: 32 columns by BF16_ADJ_ROWS source rows of
# BF16_ADJ_THREADS threads, and its staged band's bytes (the C entry checks
# the tile)
BF16_ADJ_ROWS = 32
BF16_ADJ_THREADS = 128
BAND_T_SMEM = BF16_ADJ_ROWS * 768


def forward_plan(b, v, w, dtype=torch.float32):
    """The forward kernel's launch: (tw, tv) and the grid (ceil(W / tw),
    ceil(V / tv), B).

    float32: a block of (tw, tv) threads; thread (x, y) of block (i, j, k)
    computes output (b, v, w) = (k, j*tv + y, i*tw + x) for every channel,
    where v < V and w < W.

    bf16: a tile of tw columns x tv rows, tw / BF16_COLUMNS * tv threads; thread t of block (i, j, k) computes outputs (k, j*tv + t //
    r, i*tw + BF16_COLUMNS * (t % r) + e), r = tw / BF16_COLUMNS, for e <
    BF16_COLUMNS, where v < V and w < W."""
    tw, tv = BF16_TILE if dtype is torch.bfloat16 else FWD_BLOCK
    return (tw, tv), (-(-w // tw), -(-v // tv), b)


def adjoint_plan(b, s, w, dtype=torch.float32):
    """The adjoint kernel's launch: (tw, ts) and the grid (ceil(W / tw),
    ceil(S / ts), B).

    float32: a block of (tw, ts) threads; thread (x, y) of block (i, j, k)
    computes dx (b, s, w) = (k, j*ts + y, i*tw + x) for every channel.

    bf16: a tile of tw columns x ts = BF16_ADJ_ROWS source rows of
    BF16_ADJ_THREADS threads; thread t of block (i, j, k)
    sums dx (k, j*ts + n*(t // 32) + e, i*tw + t % 32), n = ts * tw /
    BF16_ADJ_THREADS consecutive rows of one column, for e < n, where s < S
    and w < W (the tile's rows leave through shared memory)."""
    if dtype is torch.bfloat16:
        tw, ts = BF16_TILE[0], BF16_ADJ_ROWS
    else:
        tw, ts = FWD_BLOCK[0], ADJ_ROWS
    return (tw, ts), (-(-w // tw), -(-s // ts), b)


def _launch(kernel, entry, src, alpha, intercept, out_rows):
    """Checks and the launch shared by both kernels: ``src`` (B, C, R, W)
    in, (B, C, out_rows, W) out. The C entries take the forward's geometry
    (S source rows, V output rows)."""
    dtype = _build.kernel_dtype(kernel, src, "input")
    counted = kernel if dtype is torch.float32 else kernel + "_bf16"
    _build.check_tensor(counted, src, "input", ndim=4, dtype=dtype)
    _build.check_tensor(kernel, alpha, "alpha", ndim=1, device=src.device)
    _build.check_tensor(kernel, intercept, "intercept", ndim=2, device=src.device)
    b, c, _, w = src.shape
    if alpha.shape[0] != b or tuple(intercept.shape) != (b, w):
        raise ValueError(f"{kernel}: alpha {tuple(alpha.shape)} and intercept "
                         f"{tuple(intercept.shape)} do not match {tuple(src.shape)}")
    if out_rows <= 0:
        raise ValueError(f"{kernel}: {out_rows} output rows")
    if kernel == "resample_rows":
        (tw, tv), (_, gy, gz) = forward_plan(b, out_rows, w, dtype)
        if gy > GRID_MAX or gz > GRID_MAX:
            raise ValueError(f"{kernel}: at most {GRID_MAX} images and "
                             f"{tv * GRID_MAX} output rows")
        geometry = [src.shape[2], w, out_rows, tw, tv]
    else:
        (tw, ts), (_, gy, gz) = adjoint_plan(b, out_rows, w, dtype)
        if gy > GRID_MAX or gz > GRID_MAX:
            raise ValueError(f"{kernel}: at most {GRID_MAX} images and "
                             f"{ts * GRID_MAX} source rows")
        geometry = [out_rows, w, src.shape[2]]
        if dtype is torch.bfloat16:
            geometry += [tw, ts]
    out = torch.empty((b, c, out_rows, w), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _build.launch(counted, _build.entry(entry, dtype), _build.ptr(src), _build.ptr(alpha),
                  _build.ptr(intercept), _build.ptr(out), b, c, *geometry,
                  _build.stream_of(src))
    return out


class _ResampleRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, intercept, out_len):
        ctx.save_for_backward(alpha, intercept)
        ctx.src_len = x.shape[2]
        if x.device.type == "cpu":
            return resample_rows_ref(x, alpha, intercept, out_len)
        return _launch("resample_rows", "gk_resample_rows", x, alpha,
                       intercept, out_len)

    @staticmethod
    def backward(ctx, g):
        alpha, intercept = ctx.saved_tensors
        return (_ResampleRowsT.apply(g.contiguous(), alpha, intercept, ctx.src_len),
                None, None, None)


class _ResampleRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, alpha, intercept, src_len):
        ctx.save_for_backward(alpha, intercept)
        ctx.out_len = g.shape[2]
        if g.device.type == "cpu":
            return resample_rows_t_ref(g, alpha, intercept, src_len)
        return _launch("resample_rows_t", "gk_resample_rows_t", g, alpha,
                       intercept, src_len)

    @staticmethod
    def backward(ctx, gg):
        alpha, intercept = ctx.saved_tensors
        return (_ResampleRows.apply(gg.contiguous(), alpha, intercept, ctx.out_len),
                None, None, None)


def resample_rows(x, alpha, intercept, out_len):
    """(B, C, S, W) -> (B, C, out_len, W): the CUDA kernel on CUDA tensors
    (float32 or bfloat16 x, contiguous; float32 alpha (B,) and intercept
    (B, W)), the plain version on
    CPU tensors. Differentiable to any order in ``x``."""
    return _ResampleRows.apply(x, alpha, intercept, int(out_len))


def resample_rows_t(g, alpha, intercept, src_len):
    """Adjoint of ``resample_rows``: (B, C, V, W) -> (B, C, src_len, W).
    Differentiable to any order in ``g``."""
    return _ResampleRowsT.apply(g, alpha, intercept, int(src_len))
