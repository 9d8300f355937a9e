"""The index algebra and arithmetic of seven CUDA kernels, mirrored in plain
PyTorch (numpy for the fused act) on the CPU and held against the JAX
package.

The kernels run only on the card (tests/test_torch_gpu.py); these mirrors
compute what they compute, step for step, so that their algebra is checked
here on every run. None of them is on a path of the port.

* csrc/styled_up_conv.cu: the stride-2 transposed conv split into its four
  output phase classes with 4, 2, 2 and 1 taps, then the 4x4 blur (pad 1,
  gain 4, as separable 1-D taps) and the epilogue; held against the JAX
  package's ``styled_up_conv3x3_ref`` (the composed sub-pixel form) and
  ``styled_up_conv3x3_xla`` (conv_transpose + blur) at a ragged shape,
  1e-5 absolute (sums of 4 * Cin = 32 terms of O(0.1)).
* csrc/styled_conv_narrow.cu (both bodies at Cout 16-64): x * s staged in
  16-channel chunks with zero fill past Cin, each output the sum over the
  chunks' channels, then the live taps dx, then dy; the up body as the
  transposed conv's four phase classes over the (H+1) x (W+1) class
  positions (4, 2, 2 and 1 live taps), then the blur and the epilogue
  with demod after the blur; held against the JAX package's
  ``styled_conv3x3_ref``, ``styled_up_conv3x3_ref`` and
  ``styled_up_conv3x3_xla`` at a ragged shape with Cin = 20 (one full
  chunk and one mostly zero), 1e-5 absolute (sums of 9 * Cin = 180 terms
  of O(0.1)).
* csrc/styled_conv.cu's float32 body, block by block as
  ``tf32_plan`` lays it out: the 'same' 3x3 conv as a GEMM over 9 taps,
  128 consecutive pixels a tile by TMA's im2col walk, tap (dy, dx) reading
  pixel (y + dy - 1, x + dx - 1) with zero fill, in 32-channel stages of
  three TF32 products each summed from 0 into a partial that joins the
  running sum, the tap splits added in order, then the epilogue in the
  kernel's order; held against the JAX package's ``styled_conv3x3_ref`` at
  ragged shapes, 1e-5 absolute (sums of 9 * Cin = 360 terms of O(0.1)).
  The up body's float32 GEMM (up_gemm_kernel) by the bf16 body's im2col
  walk on the same stages, against ``styled_up_conv3x3_ref`` and
  ``_xla``; the plan's ring, boxes, tiles and tap splits at every path
  shape of ffhq256 and pidray256.
* the 3xTF32 arithmetic both StyledConvs share (csrc/tf32x3.cuh): each fp32 operand split into a TF32
  big part and a TF32 small part (round to nearest, ties away, as
  cvt.rna.tf32.f32: add half of the 13 dropped mantissa bits, then mask
  them), three products summed in fp32.
* csrc/affine_warp.cu's gather adjoint: one output element per thread, a
  candidate window of v from the monotone tap index, membership and
  coefficient from the forward's geometry; held against ``_resample_pass_t``
  and the JAX Pallas ``resample_rows_t`` in interpret mode, 1e-5 absolute
  (sums of a few products of O(1), in another order).
* csrc/sinkhorn.cu's fused schedule: one read of each row per pass, niters
  + 1 passes; a pass's row potentials and its column log-sum-exp come from
  the same read, per-chunk column partials are merged in chunk order, and
  the last pass writes q. Held against the JAX package's fused Pallas
  variant in interpret mode and the port's ``sinkhorn_knopp_ref``, 1e-4
  absolute on codes in [0, 1] (tests/test_torch_sinkhorn.py's tolerance).
* csrc/fused_act.cu's backward: the wrapper's launch plan
  (``ops/fused_act.py::launch_plan``) run block by block, each thread's
  channel group over its strided rows, the block's partial bias sums over
  its rows of threads in increasing y, then each column of partials in 32
  interleaved runs summed in increasing y; every element written once, dx
  equal to the plain backward, db within 1e-5 of ``dx.sum`` (sums of at
  most 300 terms of O(1)).
* csrc/affine_warp.cu's forward pass: the wrapper's grid and block
  (``ops/resample.py::forward_plan``), one thread per output (b, v, w) for
  every channel, covering each output exactly once; the thread's two live
  taps and lerp equal ``_resample_pass`` bit for bit and the JAX Pallas
  ``resample_rows`` in interpret mode within 1e-5. Its bf16 kernel: 8
  consecutive columns a thread in tiles of 64 rows x 32 columns, the
  tile's band of source rows reduced from the geometry and staged where it
  fits the shared buffer (else read from the image), each output covered
  once at W = 524 and 792 (8-byte and 16-byte rows); the fp32 lerps equal
  ``_resample_pass`` bit for bit on the bf16 values, and the JAX pass within
  1e-5.
* csrc/upfirdn2d.cu's tiles: each block stages its input footprint with
  zero fill, runs the vertical pass into a second buffer (or folds a single
  tap into the horizontal ones) and the horizontal pass to the outputs, the
  live taps at up = 2 chosen by the phase of the row or column, every
  staged index checked to lie inside its buffer; with the wrapper's tile
  (``ops/upfirdn2d.py::plan``) and with small tiles, so that a small input
  spans many ragged tiles. Held against the JAX package's
  ``upfirdn2d_ref`` with the 2-D kernel outer(taps_y, taps_x), 1e-5
  absolute (sums of at most 16 * 16 products of O(1)). Its bf16 kernel,
  with the bf16 plan (``plan`` at 2-byte elements): the C entry's checks,
  the vertical pass RV rows and the horizontal pass CH columns a thread,
  each reading a staged row or column once for every output it reaches,
  every output's taps counted; on bf16-rounded inputs, rounded once to
  bf16, within one bf16 step of the JAX ``upfirdn2d_ref`` on the same
  values rounded once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import importlib

from ganecdotes_tpu.ops import affine_warp_pallas as jawp
from ganecdotes_tpu.ops import modulated_conv_pallas as jmc
from ganecdotes_tpu.ops.sinkhorn_pallas import sinkhorn_knopp_pallas
from ganecdotes_torch.gan import ada
from ganecdotes_torch.ops import affine_warp as taw
from ganecdotes_torch.ops import fused_act as tfa
from ganecdotes_torch.ops import resample as trs
from ganecdotes_torch.ops import upfirdn2d as tup
from ganecdotes_torch.ops.sinkhorn import sinkhorn_knopp_ref

# ganecdotes_tpu.ops re-exports a function named upfirdn2d over the module
jup = importlib.import_module("ganecdotes_tpu.ops.upfirdn2d")

UP_TOL = dict(atol=1e-5, rtol=0)
CONV3_TOL = dict(atol=1e-5, rtol=0)
SINKHORN_TOL = dict(atol=1e-4, rtol=0)
ADJ_TOL = dict(atol=1e-5, rtol=0)
# the GPU tests' tolerance for the conv kernels against their plain
# versions (tests/test_torch_gpu.py CONV_TOL)
CONV_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread: these tensors are tiny, and a thread pool
    only adds waits, most of all when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# the up StyledConv: 9-tap sub-pixel transposed conv, blur, epilogue
# ---------------------------------------------------------------------------


def _subpixel_up_conv(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """What csrc/styled_up_conv.cu computes. T (B, 2H+1, 2W+1, Cout) row
    Y = 2m + p reads x row m with kernel row 0 and x row m - 1 with kernel
    row 2 (p = 0, m in [0, H]), or x row m with kernel row 1 (p = 1,
    m in [0, H - 1]); the same per column. Then the blur, true
    convolution with pad 1, and the epilogue."""
    xm = x * s[:, None, None, :]
    b, h, wd, _ = xm.shape
    cout = w.shape[3]
    xp = F.pad(xm, (0, 0, 1, 1, 1, 1))  # xp[:, r, c] = xm[:, r - 1, c - 1]
    t = xm.new_zeros(b, 2 * h + 1, 2 * wd + 1, cout)
    for py in (0, 1):
        for px in (0, 1):
            rows, cols = h + 1 - py, wd + 1 - px
            acc = xm.new_zeros(b, rows, cols, cout)
            for ty in range(2 - py):  # 2, 2, 1, 1 ... -> 4, 2, 2, 1 taps
                for tx in range(2 - px):
                    ky, kx = (1 if py else 2 * ty), (1 if px else 2 * tx)
                    patch = xp[:, 1 - ty:1 - ty + rows, 1 - tx:1 - tx + cols]
                    acc = acc + torch.einsum("bhwc,cd->bhwd", patch, w[ky, kx])
            t[:, py::2, px::2] = acc * demod[:, None, None, :]
    k = np.asarray(blur_kernel, np.float32)
    k1 = (np.float32(2.0) * k / k.sum())[::-1]  # flipped: true convolution
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    hz = sum(float(k1[i]) * tp[:, :, i:i + 2 * wd] for i in range(4))
    out = sum(float(k1[i]) * hz[:, i:i + 2 * h] for i in range(4))
    out = out + noise_weight * noise + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


@pytest.mark.parametrize("noise_b", [1, 2])
def test_subpixel_up_conv_phases_match_jax(noise_b):
    rng = np.random.RandomState(4)
    b, h, wd, cin, cout = 2, 3, 5, 8, 12
    args = [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, 2 * h, 2 * wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]
    ours = _np(_subpixel_up_conv(*[_t(a) for a in args]))
    assert ours.shape == (b, 2 * h, 2 * wd, cout)
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(ours, np.asarray(jmc.styled_up_conv3x3_ref(*jargs)),
                               **UP_TOL)
    np.testing.assert_allclose(ours, np.asarray(jmc.styled_up_conv3x3_xla(*jargs)),
                               **UP_TOL)


# the kernel row (or column) each tap offset d (0, 1, 2: offset d - 1)
# carries in the transposed conv's phase class p, for the live taps only
CONVT_TAPS = {0: {0: 2, 1: 0}, 1: {1: 1}}


def _narrow_conv(x, w, s, demod, noise, noise_weight, bias, up=False, chunk=16):
    """What csrc/styled_conv_narrow.cu computes. x * s in 16-channel chunks
    (zero past Cin); per output (non-up) or class position (up) the sum
    over the chunks' channels, each channel's live taps dx, then dy, of
    x[y + dy - 1][x + dx - 1] times the tap. Non-up: all 9 taps, then
    demod, noise, bias, leaky-ReLU and sqrt(2). Up: per class (py, px) of
    the transposed conv, over the (H+1) x (W+1) class positions, its live
    taps (CONVT_TAPS), written to T[2m + py][2n + px] inside (2H+1, 2W+1);
    then the blur (true convolution, pad 1) and the epilogue with demod
    after the blur."""
    xm = x * s[:, None, None, :]
    b, h, wd, cin = xm.shape
    cout = w.shape[3]
    cpad = -(-cin // chunk) * chunk
    xp = F.pad(xm, (0, cpad - cin, 1, 2, 1, 2))  # rows / columns -1 .. H + 1
    wp = F.pad(w, (0, 0, 0, cpad - cin))
    if not up:
        acc = xm.new_zeros(b, h, wd, cout)
        for c in range(cpad):
            for dx in range(3):
                for dy in range(3):
                    acc = acc + xp[:, dy:dy + h, dx:dx + wd, c, None] * wp[dy, dx, c]
        out = acc * demod[:, None, None, :]
    else:
        t = xm.new_zeros(b, 2 * h + 1, 2 * wd + 1, cout)
        for py in (0, 1):
            for px in (0, 1):
                acc = xm.new_zeros(b, h + 1, wd + 1, cout)
                for c in range(cpad):
                    for dx, kx in sorted(CONVT_TAPS[px].items()):
                        for dy, ky in sorted(CONVT_TAPS[py].items()):
                            acc = acc + (xp[:, dy:dy + h + 1, dx:dx + wd + 1, c, None]
                                         * wp[ky, kx, c])
                t[:, py::2, px::2] = acc[:, :h + 1 - py, :wd + 1 - px]
        k = np.asarray((1, 3, 3, 1), np.float32)
        k1 = (np.float32(2.0) * k / k.sum())[::-1]  # flipped: true convolution
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
        hz = sum(float(k1[i]) * tp[:, :, i:i + 2 * wd] for i in range(4))
        out = sum(float(k1[i]) * hz[:, i:i + 2 * h] for i in range(4))
        out = out * demod[:, None, None, :]
    out = out + noise_weight * noise
    out = out + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
@pytest.mark.parametrize("noise_b", [1, 2])
def test_narrow_conv_chunks_and_phase_filters_match_jax(up, noise_b):
    rng = np.random.RandomState(6)
    b, h, wd, cin, cout = 2, 5, 7, 20, 16
    f = 2 if up else 1
    args = [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, f * h, f * wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]
    ours = _np(_narrow_conv(*[_t(a) for a in args], up=up))
    assert ours.shape == (b, f * h, f * wd, cout)
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    if up:
        for ref in (jmc.styled_up_conv3x3_ref, jmc.styled_up_conv3x3_xla):
            np.testing.assert_allclose(ours, np.asarray(ref(*jargs)), **UP_TOL)
    else:
        np.testing.assert_allclose(ours, np.asarray(jmc.styled_conv3x3_ref(*jargs)),
                                   **CONV3_TOL)


def _tf32_parts(x):
    """x's TF32 big and small parts (``_tf32``): hi + lo = x to 2^-22."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _stage_3xtf32(a, b_hi, b_lo):
    """One 32-channel stage of csrc/tf32x3.cuh, summed from 0: A split into
    its TF32 parts (in the consumers' registers), B's two planes as loaded,
    the products a_lo b_hi, a_hi b_lo, a_hi b_hi; a_lo b_lo dropped."""
    a_hi, a_lo = _tf32_parts(a)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def _weight_planes(w):
    """tf32_split_weight_kernel: the (3, 3, Cin, Cout) weights as their TF32
    planes, (18, Cout, Cin): hi for taps 0-8, then lo."""
    cout, cin = w.shape[3], w.shape[2]
    return torch.cat(_tf32_parts(w.permute(0, 1, 3, 2).reshape(9, cout, cin)))


def _tap_gemm_conv(x, w, s, demod, noise, noise_weight, bias, sms=132):
    """What csrc/styled_conv.cu's float32 body computes, block by block as
    ``tf32_plan`` lays it out: block (tile m, tile n) of split z walks 128
    consecutive pixels flat over images, rows and columns by ``bn``
    channels; over its taps 9 z / nsplit .. 9 (z + 1) / nsplit and their
    32-channel stages, each stage's three products (``_stage_3xtf32``) are
    summed from 0 into a partial that then joins the running sum. Tap (dy,
    dx)'s A stage is TMA's im2col load from base pixel (x - 1, y - 1) of
    the bounding box [-1, dim - 2] at offsets (dx, dy), zero outside the
    image; B's are boxes of the weights' planes. Rows past the last pixel
    and columns past Cout are not stored. The splits' sums are added in
    split order, then demod, noise, bias, leaky-ReLU and sqrt(2), in that
    order. Returns the output, how many times each element was stored per
    split, and the plan."""
    from ganecdotes_torch.ops.modulated_conv import tf32_plan

    xm = x * s[:, None, None, :]
    b, h, wd, cin = xm.shape
    cout = w.shape[3]
    plan = tf32_plan(b, h, wd, cin, cout, False, sms)
    bm, bn, bk = plan.bm, plan.bn, plan.box[0]
    planes = _weight_planes(w)
    m_all = b * h * wd
    part = xm.new_zeros(plan.nsplit, m_all, cout)
    stored = torch.zeros(plan.nsplit, m_all, cout, dtype=torch.int64)
    for z in range(plan.nsplit):
        for blk in range(plan.tiles_m * plan.tiles_n):
            tm, tn = divmod(blk, plan.tiles_n)
            m0, n0 = tm * bm, tn * bn
            n, r0 = divmod(m0, h * wd)
            y, xx = divmod(r0, wd)
            acc = xm.new_zeros(bm, bn)
            for tap in range(9 * z // plan.nsplit, 9 * (z + 1) // plan.nsplit):
                dy, dx = divmod(tap, 3)
                for c in range(plan.chunks):
                    a = _tma_im2col(xm, (xx - 1, y - 1, n), (-1, -1), (-1, -1), (dx, dy),
                                    bk * c, bm, bk)
                    b_hi = _tma_box(planes, (bk * c, n0, tap), (bk, bn, 1))[0]
                    b_lo = _tma_box(planes, (bk * c, n0, 9 + tap), (bk, bn, 1))[0]
                    acc = acc + _stage_3xtf32(a, b_hi, b_lo)
            rows, k = min(bm, m_all - m0), min(bn, cout - n0)
            part[z, m0:m0 + rows, n0:n0 + k] = acc[:rows, :k]
            stored[z, m0:m0 + rows, n0:n0 + k] += 1
    acc = part[0]
    for p in part[1:]:
        acc = acc + p
    out = _epilogue_np(acc.reshape(b, h, wd, cout), demod, noise, noise_weight, bias)
    return out, stored, plan


# SMs on which a grid of one tile splits its taps 1, 3 or 9 ways
SMS_FOR_SPLITS = {1: 1, 3: 3, 9: 132}


@pytest.mark.parametrize("nsplit", [1, 3, 9])
@pytest.mark.parametrize("noise_b", [1, 3])
def test_tap_gemm_conv_matches_jax(noise_b, nsplit):
    """B * H * W = 105 rows (no multiple of the 128-row tile), Cout = 12 (a
    32-wide tile), Cin = 40: a full 32-channel stage and a partial one per
    tap; the taps whole or split 3 or 9 ways (the one tile's grid planned
    for 1, 3 and 132 SMs). Every output stored once per split."""
    rng = np.random.RandomState(5)
    b, h, wd, cin, cout = 3, 5, 7, 40, 12
    args = [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, h, wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]
    ours, stored, plan = _tap_gemm_conv(*[_t(a) for a in args], sms=SMS_FOR_SPLITS[nsplit])
    assert plan.nsplit == nsplit and plan.bn == 32 and bool((stored == 1).all())
    assert ours.shape == (b, h, wd, cout)
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(_np(ours), np.asarray(jmc.styled_conv3x3_ref(*jargs)),
                               **CONV3_TOL)


@pytest.mark.parametrize("shape", [(2, 9, 10, 8, 136), (1, 3, 70, 36, 64)])
def test_tf32_conv_tiles_cover_every_output_once(shape):
    """Tiles that cross rows and images (W = 10, 2 x 90 pixels: two tiles,
    the second partial) and Cout = 136 (two 128-wide tiles, the second 8
    wide); W = 70 (a tile of 128 pixels spans a row break) at Cout 64 (a
    64-wide tile), Cin 36 (a full and a nearly empty stage). Planned for
    132 SMs, so the taps split; every output stored once per split."""
    rng = np.random.RandomState(6)
    args = _styled_args(rng, *shape, 1, up=False)
    out, stored, plan = _tap_gemm_conv(*[_t(a) for a in args])
    assert plan.nsplit > 1 and bool((stored == 1).all())
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(_np(out), np.asarray(jmc.styled_conv3x3_ref(*jargs)),
                               **CONV3_TOL)


@pytest.mark.parametrize("m,cout,want", [
    (8 * 4 * 4, 512, 9), (8 * 16 * 16, 512, 9), (1 * 32 * 32, 512, 3),
    (20 * 8 * 8, 512, 3), (8 * 32 * 32, 512, 1), (8 * 256 * 256, 128, 1),
    (99, 100, 9)])
def test_tap_splits_only_split_an_underfilled_grid(m, cout, want):
    """On 132 SMs: the ffhq layers 4x4 and 16x16 at B = 8, 32x32 at B = 1,
    8x8 at B = 20, two layers that fill the card, and a ragged one."""
    from ganecdotes_torch.ops.modulated_conv import tap_splits

    assert tap_splits(m, cout, 132) == want


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_3xtf32_split_keeps_fp32_accuracy():
    """At the deepest K of the path (9 * 512) and outputs of magnitude ~10,
    the three products of the big and small TF32 parts, summed in fp32, stay
    within the conv tolerance of the fp32 product; the big parts alone
    (plain TF32) do not, which is why the kernel splits."""
    k = 9 * 512
    rng = np.random.RandomState(0)
    a = _t(rng.randn(64, k))
    b = _t(rng.randn(k, 48) * 10 / np.sqrt(k))
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    assert torch.equal(_tf32(a_hi), a_hi) and torch.equal(_tf32(a_lo), a_lo)
    fp32 = a @ b
    assert 5 < float(fp32.abs().max()) < 100
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    torch.testing.assert_close(three, fp32, **CONV_TOL)
    exact = a.double() @ b.double()
    err3 = float((three.double() - exact).abs().max())
    assert err3 <= 2 * float((fp32.double() - exact).abs().max())
    plain = a_hi @ b_hi
    with pytest.raises(AssertionError):
        torch.testing.assert_close(plain, fp32, **CONV_TOL)
    assert float((plain.double() - exact).abs().max()) > 10 * err3


# ---------------------------------------------------------------------------
# the bf16 StyledConvs' TMA + wgmma tiling (csrc/bf16_wgmma.cuh)
# ---------------------------------------------------------------------------


def _tma_box(src, coords, box):
    """TMA's tiled mode: the box of ``box`` elements (innermost first) of
    ``src`` at ``coords`` (innermost first, any sign), zero wherever it lies
    outside ``src``; shaped as ``box`` reversed."""
    out = src.new_zeros(tuple(box[::-1]))
    dst, sel = [], []
    for c, n, d in zip(coords, box, src.shape[::-1]):
        lo, hi = max(c, 0), min(c + n, d)
        if lo >= hi:
            return out
        dst.append(slice(lo - c, hi - c))
        sel.append(slice(lo, hi))
    out[tuple(dst[::-1])] = src[tuple(sel[::-1])]
    return out


def _tma_im2col(src, start, lower, upper, offsets, c0, pixels, channels):
    """TMA's im2col mode on NHWC ``src``: ``pixels`` base positions from
    ``start`` = (w, h, n) on, walking w, then h, then n inside the bounding
    box [lower, dim - 1 + upper] of each axis (W first); row i holds
    channels c0 .. c0 + channels - 1 of pixel (w + offsets[0], h +
    offsets[1]) of image n, zero outside the tensor (channels past C,
    pixels outside the image, images past B)."""
    b, h_len, w_len, c_len = src.shape
    w, h, n = start
    rows = src.new_zeros(pixels, channels)
    for i in range(pixels):
        x, y = w + offsets[0], h + offsets[1]
        if n < b and 0 <= y < h_len and 0 <= x < w_len and c0 < c_len:
            seg = src[n, y, x, c0:c0 + channels]
            rows[i, :len(seg)] = seg
        w += 1
        if w > w_len - 1 + upper[0]:
            w, h = lower[0], h + 1
        if h > h_len - 1 + upper[1]:
            h, n = lower[1], n + 1
    return rows


def _epilogue_np(acc, demod, noise, noise_weight, bias):
    out = acc * demod[:, None, None, :]
    out = out + noise_weight * noise
    out = out + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


def _blur_epilogue(t, noise, noise_weight, bias, blur_kernel=(1, 3, 3, 1)):
    """up_blur_epilogue_kernel: the 4x4 blur of T (true convolution, pad 1,
    gain 4 as separable 1-D taps), then noise, bias, leaky-ReLU, sqrt(2)."""
    h2, w2 = t.shape[1] - 1, t.shape[2] - 1
    k = np.asarray(blur_kernel, np.float32)
    k1 = (np.float32(2.0) * k / k.sum())[::-1]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    hz = sum(float(k1[i]) * tp[:, :, i:i + w2] for i in range(4))
    out = sum(float(k1[i]) * hz[:, i:i + h2] for i in range(4))
    out = out + noise_weight * noise + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


def _wgmma_tile_conv(x, w, s, demod, noise, noise_weight, bias, sms=132):
    """What csrc/styled_conv.cu's bf16 body computes, in float32, block by
    block as ``bf16_plan`` lays it out: block (tile m, tile n) of split z
    sums, over its taps and 64-channel stages, the bm x 64 A stage (the
    tiled box of x * s at the tap's shifted coordinates, zero filled; the
    rows past the box hold the last stage's leftovers, here NaN) times the
    bn x 64 B stage (the weights' box); tile row r is pixel (x0 + r % tw,
    y0 + r // tw % th, b0 + r // (tw th)) and is stored only where that is
    a pixel. The splits' sums are added in split order, then the epilogue.
    Returns the output and how many times each element was stored."""
    from ganecdotes_torch.ops.modulated_conv import bf16_plan

    xm = x * s[:, None, None, :]
    b, h, wd, cin = xm.shape
    cout = w.shape[3]
    plan = bf16_plan(b, h, wd, cin, cout, False, sms)
    bm, bn, (_, tw, th, nb), (tiles_x, tiles_y, _) = plan.bm, plan.bn, plan.box, plan.tiles
    w_taps = w.permute(0, 1, 3, 2).reshape(9, cout, cin)
    rows = tw * th * nb
    part = xm.new_zeros(plan.nsplit, b, h, wd, cout)
    stored = torch.zeros(plan.nsplit, b, h, wd, cout, dtype=torch.int64)
    for z in range(plan.nsplit):
        for blk in range(plan.tiles_m * plan.tiles_n):
            tm, tn = divmod(blk, plan.tiles_n)
            n0 = tn * bn
            x0, y0 = tm % tiles_x * tw, tm // tiles_x % tiles_y * th
            b0 = tm // (tiles_x * tiles_y) * nb
            acc = xm.new_zeros(bm, bn)
            for tap in range(9 * z // plan.nsplit, 9 * (z + 1) // plan.nsplit):
                dy, dx = divmod(tap, 3)
                for c in range(plan.chunks):
                    a = xm.new_full((bm, 64), float("nan"))
                    a[:rows] = _tma_box(xm, (64 * c, x0 + dx - 1, y0 + dy - 1, b0),
                                        plan.box).reshape(rows, 64)
                    wb = _tma_box(w_taps, (64 * c, n0, tap), (64, bn, 1))[0]
                    acc = acc + a @ wb.T
            for r in range(bm):
                xi, q = r % tw, r // tw
                yy, bi = y0 + q % th, b0 + q // th
                xx = x0 + xi
                if q // th < nb and bi < b and yy < h and xx < wd:
                    k = min(bn, cout - n0)
                    part[z, bi, yy, xx, n0:n0 + k] = acc[r, :k]
                    stored[z, bi, yy, xx, n0:n0 + k] += 1
    acc = part[0]
    for p in part[1:]:
        acc = acc + p
    return _epilogue_np(acc, demod, noise, noise_weight, bias), stored


def _wgmma_im2col_up_conv(x, w, s, demod, noise, noise_weight, bias, sms=132,
                          tf32=False):
    """What csrc/styled_up_conv.cu's bf16 body computes, in float32 (or,
    ``tf32``, its float32 body, up_gemm_kernel on csrc/tf32x3.cuh): per
    phase class (py, px), block (tile m, tile n) walks bm positions of the
    (H + 1) x (W + 1) grid of every image from m0 on; tap (ty, tx)'s A
    stage is TMA's im2col load from base pixel (x - 1, y - 1) of the
    position (the bounding box [-1, dim - 1]) at offsets (1 - tx, 1 - ty),
    64 channels (tf32: 32, and each stage's three TF32 products against the
    weights' planes summed from 0 into a partial, ``_stage_3xtf32``);
    position (y, x) of image b is stored, times demod, to T[b, 2y + py,
    2x + px] where it lies in the class's (H + 1 - py) x (W + 1 - px).
    Then the blur and the epilogue. Returns the output and how many times
    each element of T was stored."""
    from ganecdotes_torch.ops.modulated_conv import bf16_plan, tf32_plan

    xm = x * s[:, None, None, :]
    b, h, wd, cin = xm.shape
    cout = w.shape[3]
    plan = (tf32_plan if tf32 else bf16_plan)(b, h, wd, cin, cout, True, sms)
    bm, bn, bk = plan.bm, plan.bn, plan.box[0]
    w_taps = _weight_planes(w) if tf32 else w.permute(0, 1, 3, 2).reshape(9, cout, cin)
    hg, wg = h + 1, wd + 1
    t = xm.new_full((b, 2 * h + 1, 2 * wd + 1, cout), float("nan"))
    stored = torch.zeros(t.shape, dtype=torch.int64)
    per_class = plan.tiles_m * plan.tiles_n
    for blk in range(plan.blocks):
        cls, local = divmod(blk, per_class)
        py, px = cls >> 1, cls & 1
        m0, n0 = local // plan.tiles_n * bm, local % plan.tiles_n * bn
        n, r0 = divmod(m0, hg * wg)
        y, xx = divmod(r0, wg)
        ntx = 2 - px
        acc = xm.new_zeros(bm, bn)
        for tap in range((2 - py) * ntx):
            ty, tx = (tap >> 1, tap & 1) if ntx == 2 else (tap, 0)
            ky, kx = (1 if py else 2 * ty), (1 if px else 2 * tx)
            for c in range(plan.chunks):
                a = _tma_im2col(xm, (xx - 1, y - 1, n), (-1, -1), (0, 0),
                                (1 - tx, 1 - ty), bk * c, *plan.box[::-1])
                wb = _tma_box(w_taps, (bk * c, n0, 3 * ky + kx), (bk, bn, 1))[0]
                if tf32:
                    lo = _tma_box(w_taps, (bk * c, n0, 9 + 3 * ky + kx), (bk, bn, 1))[0]
                    acc = acc + _stage_3xtf32(a, wb, lo)
                else:
                    acc = acc + a @ wb.T
        for r in range(bm):
            bi, q = divmod(m0 + r, hg * wg)
            yy, xc = divmod(q, wg)
            if bi < b and yy < hg - py and xc < wg - px:
                k = min(bn, cout - n0)
                t[bi, 2 * yy + py, 2 * xc + px, n0:n0 + k] = acc[r, :k] * demod[bi, n0:n0 + k]
                stored[bi, 2 * yy + py, 2 * xc + px, n0:n0 + k] += 1
    return _blur_epilogue(t, noise, noise_weight, bias), stored


def _styled_args(rng, b, h, wd, cin, cout, noise_b, up):
    f = 2 if up else 1
    return [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, f * h, f * wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]


@pytest.mark.parametrize("shape,noise_b", [
    ((3, 5, 7, 72, 24), 3),   # Cin 72: a full and a partial stage; one box over 3 images
    ((20, 4, 4, 16, 40), 1),  # boxes of 8 images, the last one partial; Cin 16
    ((2, 3, 70, 8, 136), 2),  # W 70: a full and a partial column box; Cout 136 < 256
    ((1, 9, 5, 24, 16), 1),   # 9 rows of 5: a box of 45 pixels
    ((4, 8, 20, 16, 24), 4)])  # on 1 SM, 256-row tiles of 160-pixel boxes
@pytest.mark.parametrize("sms", [132, 1], ids=["split", "whole"])
def test_wgmma_tile_conv_matches_jax(shape, noise_b, sms):
    """The non-up bf16 body's tiles, boxes and tap splits (9 or 3 on 132
    SMs, none on 1; on 1 SM, 256-row tiles where they make two waves)
    against the JAX package's ``styled_conv3x3_ref``; every output stored
    once per split, and none of the NaN leftover rows read."""
    rng = np.random.RandomState(8)
    args = _styled_args(rng, *shape, noise_b, up=False)
    out, stored = _wgmma_tile_conv(*[_t(a) for a in args], sms=sms)
    assert bool((stored == 1).all())
    b, h, wd, _, cout = shape
    assert out.shape == (b, h, wd, cout) and bool(torch.isfinite(out).all())
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(_np(out), np.asarray(jmc.styled_conv3x3_ref(*jargs)),
                               **CONV3_TOL)


@pytest.mark.parametrize("shape,noise_b", [
    ((2, 3, 5, 72, 24), 2),   # Cin 72; 2 x 4 x 6 = 48 positions, one tile a class
    ((3, 4, 9, 16, 40), 1),   # Cin 16 (a stage mostly zeros); 150 positions, 2 tiles
    ((1, 2, 2, 8, 264), 1),   # Cout 264: two 256-wide tiles, the second 8 wide
    ((2, 15, 15, 8, 16), 2)])  # on 1 SM, two 256-row tiles of 512 positions
def test_wgmma_im2col_up_conv_matches_jax(shape, noise_b):
    """The up bf16 body's im2col walk (every class over the (H + 1) x
    (W + 1) positions, tap offsets, the class's positions stored; the last
    shape planned for 1 SM, so 256 rows a tile) against the JAX package's
    ``styled_up_conv3x3_ref`` and ``styled_up_conv3x3_xla``; every element
    of T stored exactly once."""
    rng = np.random.RandomState(9)
    args = _styled_args(rng, *shape, noise_b, up=True)
    sms = 1 if shape[1] == 15 else 132
    out, stored = _wgmma_im2col_up_conv(*[_t(a) for a in args], sms=sms)
    assert bool((stored == 1).all())
    b, h, wd, _, cout = shape
    assert out.shape == (b, 2 * h, 2 * wd, cout) and bool(torch.isfinite(out).all())
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    for ref in (jmc.styled_up_conv3x3_ref, jmc.styled_up_conv3x3_xla):
        np.testing.assert_allclose(_np(out), np.asarray(ref(*jargs)), **UP_TOL)


@pytest.mark.parametrize("shape,noise_b", [
    ((2, 3, 5, 72, 24), 2),   # Cin 72: two full stages and a partial one; 48 positions
    ((3, 4, 9, 16, 40), 1),   # Cin 16 (a stage half zeros); 150 positions, 2 tiles; 64 wide
    ((1, 2, 2, 8, 264), 1),   # Cout 264: three 128-wide tiles, the last 8 wide
    ((2, 15, 15, 8, 16), 2)])  # 512 positions: four tiles a class
def test_tf32_im2col_up_conv_matches_jax(shape, noise_b):
    """The up float32 body's im2col walk (csrc/styled_up_conv.cu
    up_gemm_kernel: every class over the (H + 1) x (W + 1) positions, tap
    offsets, the weights' TF32 planes, 32-channel stages summed from 0)
    against the JAX package's ``styled_up_conv3x3_ref`` and
    ``styled_up_conv3x3_xla``; every element of T stored exactly once."""
    rng = np.random.RandomState(9)
    args = _styled_args(rng, *shape, noise_b, up=True)
    out, stored = _wgmma_im2col_up_conv(*[_t(a) for a in args], tf32=True)
    assert bool((stored == 1).all())
    b, h, wd, _, cout = shape
    assert out.shape == (b, 2 * h, 2 * wd, cout) and bool(torch.isfinite(out).all())
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    for ref in (jmc.styled_up_conv3x3_ref, jmc.styled_up_conv3x3_xla):
        np.testing.assert_allclose(_np(out), np.asarray(ref(*jargs)), **UP_TOL)


# The float32 GEMMs' tap splits at the non-up layers 4^2 .. 256^2 (widths
# 512 to 128) on 132 SMs, per batch: ffhq256's serving (B = 1, 8, 32) and
# pidray256's G (B = 20; PPL's B = 10)
TF32_TAP_SPLITS = {1: (9, 9, 9, 3, 1, 1, 1), 8: (9, 9, 9, 1, 1, 1, 1),
                   32: (9, 9, 1, 1, 1, 1, 1), 10: (9, 9, 3, 1, 1, 1, 1),
                   20: (9, 3, 1, 1, 1, 1, 1)}


@pytest.mark.parametrize("b", [1, 8, 32, 10, 20])
@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_tf32_plan_fits_at_every_path_shape(b, up):
    """At every float32 StyledConv shape of ffhq256 and pidray256 (their
    generators' widths, 512 at 4^2 to 128 at 256^2) at each batch: the ring
    within the 227 KB a block may use, with room for the fp32 staged tile;
    TMA boxes of 128-byte rows (32 float32 channels, the swizzle's span)
    and 16-byte multiples of every global stride; 128-row tiles covering the
    pixels (non-up) or each class's (h + 1) x (w + 1) positions (up) and
    128-wide tiles covering Cout; the tap splits only where a grid has
    fewer tiles than SMs (TF32_TAP_SPLITS; the up body never splits)."""
    from ganecdotes_torch.models.stylegan2.generator import channel_map
    from ganecdotes_torch.ops import modulated_conv as tmc

    ch = channel_map()
    res = [2 ** k for k in range(2, 9)]
    shapes = ([(b, r // 2, r // 2, ch[r // 2], ch[r]) for r in res[1:]] if up
              else [(b, r, r, ch[r], ch[r]) for r in res])
    assert tmc.TF32_BK * 4 == 128
    splits = []
    for bb, h, w, cin, cout in shapes:
        p = tmc.tf32_plan(bb, h, w, cin, cout, up)
        assert p.smem_bytes <= tmc.BF16_SMEM_LIMIT
        assert p.bm * (p.bn + 8) * 4 <= p.stages * p.stage_bytes
        assert p.stage_bytes == 4 * 32 * (128 + 2 * p.bn) and p.stage_bytes % 1024 == 0
        assert p.stages == 4 and p.bn == 128 and p.bm == 128
        assert p.box == (32, 128) and p.mode == "im2col" and p.chunks * 32 >= cin
        for stride in (cin * 4, w * cin * 4, h * w * cin * 4, cout * cin * 4):
            assert stride % 16 == 0
        m = bb * (h + 1) * (w + 1) if up else bb * h * w
        assert (p.tiles_m - 1) * 128 < m <= p.tiles_m * 128
        assert (p.tiles_n - 1) * p.bn < cout <= p.tiles_n * p.bn
        assert p.blocks == (4 if up else p.nsplit) * p.tiles_m * p.tiles_n
        assert p.nsplit == 1 or p.tiles_m * p.tiles_n < 132
        splits.append(p.nsplit)
    assert tuple(splits) == ((1,) * 6 if up else TF32_TAP_SPLITS[b])


def _chip_smoke():
    """chip_smoke.py as a module (its phase 16 (a) shapes and ADA draw)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _phase16_styled_shapes():
    """chip_smoke.py's phase 16 (a) StyledConv rows: the ffhq-256 request of
    8, the pidray G step at B = 20 at the rosinality and lean widths."""
    return [(name == "styled_up_conv3x3", shape)
            for name, _, shape, _, _ in _chip_smoke().bf16_styled_shapes()]


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_bf16_plan_fits_at_every_phase16_shape(up):
    """At every bf16 StyledConv shape chip_smoke.py's phase 16 (a) runs:
    the ring within the 227 KB a block may use, with room for the fp32
    staged tile; TMA boxes of at most 256 a side, 128-byte rows (the
    swizzle's span) and 16-byte multiples of every global stride; 128-row
    or 256-row tiles (two wgmma warpgroups of 64-row blocks) that the box
    fills; the grid covering the pixels (non-up) or positions (up) and
    Cout."""
    from ganecdotes_torch.ops import modulated_conv as tmc

    shapes = [s for u, s in _phase16_styled_shapes() if u == up]
    assert len(shapes) == (18 if up else 21)
    assert tmc.BF16_BK * 2 == 128
    for b, h, w, cin, cout in shapes:
        p = tmc.bf16_plan(b, h, w, cin, cout, up)
        assert p.bm in tmc.BF16_BMS and p.bm * p.bn <= 256 * 128
        assert p.smem_bytes <= tmc.BF16_SMEM_LIMIT
        assert p.bm * (p.bn + 8) * 4 <= p.stages * p.stage_bytes
        assert p.stage_bytes % 1024 == 0 and 4 <= p.stages <= tmc.BF16_MAX_STAGES
        assert all(d <= tmc.BF16_BOX_MAX for d in p.box) and p.box[0] * 2 == 128
        for stride in (cin * 2, w * cin * 2, h * w * cin * 2, cout * cin * 2):
            assert stride % 16 == 0
        assert p.tiles_n * p.bn >= cout > p.tiles_n * p.bn - p.bn
        assert p.bn in (16, 32, 64, 128, 256)
        if up:
            assert p.box == (64, p.bm) and p.tiles_m * p.bm >= b * (h + 1) * (w + 1)
        else:
            _, tw, th, nb = p.box
            assert tw * th * nb == p.bm or (tw, th, nb) == (w, h, b)
            tx, ty, tb = p.tiles
            assert tx * tw >= w and ty * th >= h and tb * nb >= b
            assert p.nsplit in (1, 3, 9)


# ---------------------------------------------------------------------------
# the resample adjoint as a gather
# ---------------------------------------------------------------------------


def _geometry(alpha, icpt, v):
    """csrc/affine_warp.cu geometry(): (k0, e1, f), each step one rounded
    float32 operation; broadcasts."""
    U = torch.floor(icpt)
    vfrac = icpt - U
    au = alpha * v
    q = torch.floor(au)
    e_in = (au - q) + vfrac
    e = torch.floor(e_in)
    return U.to(torch.int64) + q.to(torch.int64), e == 1, e_in - e


def _window(alpha, icpt, s_len, v_len):
    """Each (b, s, w)'s candidate rows [v0, v1] of the cotangent: the ends
    (s - 2 - U)/alpha and (s + 1 - U)/alpha (times a rounded 1/alpha),
    widened by one, clipped; all of [0, V) where alpha = 0 or where 1/alpha
    overflows (a subnormal alpha)."""
    s = torch.arange(s_len, dtype=torch.float32)[None, :, None]
    U = torch.floor(icpt)[:, None, :]
    a = alpha[:, None, None]
    inv = 1 / a
    full = (a == 0) | ~torch.isfinite(inv)
    inv = torch.where(full, 0.0, inv)
    e0 = ((s - 2) - U) * inv
    e1 = ((s + 1) - U) * inv
    lo = torch.minimum(e0, e1).clamp(-2, v_len + 1)
    hi = torch.maximum(e0, e1).clamp(-2, v_len + 1)
    v0 = (torch.floor(lo).to(torch.int64) - 1).clamp(min=0)
    v1 = (torch.ceil(hi).to(torch.int64) + 1).clamp(max=v_len - 1)
    full = full.expand_as(v0)
    return torch.where(full, 0, v0), torch.where(full, v_len - 1, v1)


def _gather_adjoint(g, alpha, icpt, s_len):
    """dx[b, c, s, w] = sum over the candidate v of coef_t(v) * g[b, c, v, w],
    t = s - k0(v) in {0, 1, 2}, summed in increasing v (the kernels' order:
    one rounded add per member, a non-member adding an exact zero)."""
    b, c, v_len, w = g.shape
    v0, v1 = _window(alpha, icpt, s_len, v_len)
    span = int((v1 - v0).max()) + 1
    cand = v0[..., None] + torch.arange(span)  # (B, S, W, L)
    inside = cand <= v1[..., None]
    cand = cand.clamp(max=v_len - 1)
    k0, e1, f = _geometry(alpha[:, None, None, None], icpt[:, None, :, None],
                          cand.to(torch.float32))
    t = torch.arange(s_len)[None, :, None, None] - k0
    one_f = 1 - f
    coef = torch.where(t == 0, torch.where(e1, 0.0, one_f),
                       torch.where(t == 1, torch.where(e1, one_f, f),
                                   torch.where(e1, f, 0.0)))
    coef = torch.where(inside & (t >= 0) & (t <= 2), coef, 0.0)
    gv = g[torch.arange(b)[:, None, None, None, None],
           torch.arange(c)[None, :, None, None, None], cand[:, None],
           torch.arange(w)[None, None, None, :, None]]
    terms = coef[:, None] * gv
    out = torch.zeros(terms.shape[:-1])
    for i in range(span):
        out = out + terms[..., i]
    return out


@pytest.mark.parametrize("alpha", [None, "neg", 0.0, 0.05, -0.05, 1e-40],
                         ids=["pos", "neg", "zero", "small", "small_neg", "subnormal"])
def test_gather_adjoint_window_and_membership_match_jax(alpha):
    b, c, s_len, w, v_len = 2, 2, 23, 19, 17
    rng = np.random.RandomState(7)
    g = rng.randn(b, c, v_len, w).astype(np.float32)
    a = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    icpt = (rng.rand(b, w) * (s_len + 10) - 5).astype(np.float32)
    if alpha is not None and alpha != "neg":
        a = np.full(b, alpha, np.float32)
    if alpha == "neg" or (alpha is not None and alpha != "neg" and alpha < 0):
        a, icpt = -a, (icpt + 0.8 * s_len).astype(np.float32)
    ta, ti = _t(a), _t(icpt)

    # every v whose taps reach s lies in s's window, and they are contiguous
    k0, _, _ = _geometry(ta[:, None, None], ti[:, None, :],
                         torch.arange(v_len, dtype=torch.float32)[None, :, None])
    v0, v1 = _window(ta, ti, s_len, v_len)
    for s in range(s_len):
        hit = (k0 >= s - 2) & (k0 <= s)  # (B, V, W)
        for bb in range(b):
            for ww in range(w):
                vs = torch.nonzero(hit[bb, :, ww]).flatten()
                if len(vs):
                    assert v0[bb, s, ww] <= vs.min() and vs.max() <= v1[bb, s, ww]
                    assert len(vs) == int(vs.max() - vs.min()) + 1

    ours = _gather_adjoint(_t(g), ta, ti, s_len)
    assert ours.shape == (b, c, s_len, w)
    np.testing.assert_allclose(_np(ours), _np(taw._resample_pass_t(_t(g), ta, ti, s_len)),
                               **ADJ_TOL)
    want = jawp.resample_rows_t(jnp.asarray(g), jnp.asarray(a), jnp.asarray(icpt), s_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **ADJ_TOL)


def _forward_pass(x, alpha, icpt, v_len):
    """csrc/affine_warp.cu's forward at the wrapper's launch: every thread
    of every block maps to (b, v, w) = (k, j*tv + y, i*tw + x), skips what
    lies outside (V, W), and for each channel reads the two live taps (k0
    or, with the carry, k0 + 1, and the next) and lerps them. Returns the
    output and how often each (b, v, w) was computed."""
    b, c, s_len, w = x.shape
    (tw, tv), (gx, gy, gz) = trs.forward_plan(b, v_len, w)
    assert gy <= trs.GRID_MAX and gz <= trs.GRID_MAX
    # every thread of the grid at once: (gz, gy, tv, gx, tw)
    bb = torch.arange(gz)[:, None, None, None, None]
    vv = (torch.arange(gy)[:, None] * tv + torch.arange(tv))[None, :, :, None, None]
    ww = (torch.arange(gx)[:, None] * tw + torch.arange(tw))[None, None, None]
    bb, vv, ww = torch.broadcast_tensors(bb, vv, ww)
    live = (vv < v_len) & (ww < w)
    bb, vv, ww = bb[live], vv[live], ww[live]
    hits = torch.zeros(b, v_len, w, dtype=torch.int64)
    hits.index_put_((bb, vv, ww), torch.ones_like(bb), accumulate=True)
    k0, e1, f = _geometry(alpha[bb], icpt[bb, ww], vv.to(torch.float32))
    klo = k0 + e1.to(torch.int64)
    out = torch.zeros(b, c, v_len, w)
    for ch in range(c):
        taps = []
        for k in (klo, klo + 1):
            inside = (k >= 0) & (k < s_len)
            taps.append(torch.where(inside, x[bb, ch, k.clamp(0, s_len - 1), ww], 0.0))
        out[bb, ch, vv, ww] = (1 - f) * taps[0] + f * taps[1]
    return out, hits


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("alpha", [None, "neg", 0.0], ids=["pos", "neg", "zero"])
def test_resample_forward_threads_cover_each_output_once(c, alpha):
    """W and V no multiple of the block (32 x 8), intercepts off both ends
    of the source column, C = 1, 3 (ADA) and 4."""
    b, s_len, w, v_len = 2, 23, 37, 19
    rng = np.random.RandomState(c)
    x = rng.randn(b, c, s_len, w).astype(np.float32)
    a = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    icpt = (rng.rand(b, w) * (s_len + 10) - 5).astype(np.float32)
    if alpha == "neg":
        a, icpt = -a, (icpt + 0.8 * s_len).astype(np.float32)
    elif alpha is not None:
        a = np.full(b, alpha, np.float32)
    ours, hits = _forward_pass(_t(x), _t(a), _t(icpt), v_len)
    assert bool((hits == 1).all())
    plain = taw._resample_pass(_t(x), _t(a), _t(icpt), axis=2, out_len=v_len)
    assert torch.equal(ours, plain)
    want = jawp.resample_rows(jnp.asarray(x), jnp.asarray(a), jnp.asarray(icpt), v_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **ADJ_TOL)


def _forward_pass_bf16(x, alpha, icpt, v_len):
    """csrc/affine_warp.cu's bf16 forward at the wrapper's launch, block by
    block: the tile's outputs (BF16_COLUMNS consecutive columns a thread),
    its band of source rows reduced from the valid outputs'
    geometry, staged (the tile's columns, zero past W and in the rows
    outside the image) where all channels fit BAND_SMEM bytes, else read
    from the image; every staged read, unchecked in the kernel, checked
    here to lie in the band. Returns the fp32 lerps
    (before the rounding on the store), how often each (b, v, w) was
    computed, and how many tiles were staged and not."""
    b, c, s_len, w = x.shape
    (tw, tv), (gx, gy, gz) = trs.forward_plan(b, v_len, w, torch.bfloat16)
    nw = trs.BF16_COLUMNS
    threads = (tw // nw) * tv
    assert threads == 128 and gy <= trs.GRID_MAX and gz <= trs.GRID_MAX
    out = torch.zeros(b, c, v_len, w)
    hits = torch.zeros(b, v_len, w, dtype=torch.int64)
    tiles = {"staged": 0, "direct": 0}
    for k in range(gz):
        for j in range(gy):
            for i in range(gx):
                # thread t: row t // (tw / nw), columns nw * (t % (tw / nw)) + e
                t = torch.arange(threads)
                vv = (j * tv + t // (tw // nw))[:, None].expand(threads, nw)
                ww = i * tw + nw * (t % (tw // nw))[:, None] + torch.arange(nw)
                live = (vv < v_len) & (ww < w)
                vv, ww = vv[live], ww[live]
                hits[k].index_put_((vv, ww), torch.ones_like(vv), accumulate=True)
                k0, e1, f = _geometry(alpha[k], icpt[k, ww], vv.to(torch.float32))
                klo = k0 + e1.to(torch.int64)
                r0, r1 = int(klo.min()), int(klo.max()) + 1
                rows = r1 - r0 + 1
                staged = c * rows * tw * 2 <= trs.BAND_SMEM
                tiles["staged" if staged else "direct"] += 1
                taps = []
                if staged:  # rows r0..r1, zero outside the image and past W
                    band = torch.zeros(c, rows, tw)
                    s0, s1 = max(r0, 0), min(r1, s_len - 1)
                    cols = slice(i * tw, min(i * tw + tw, w))
                    if s1 >= s0:
                        band[:, s0 - r0:s1 - r0 + 1, :cols.stop - cols.start] = \
                            x[k, :, s0:s1 + 1, cols]
                for kk in (klo, klo + 1):
                    if staged:  # unchecked, as the kernel reads
                        r = kk - r0
                        assert bool(((r >= 0) & (r < rows)).all())
                        tap = band[:, r, ww - i * tw]
                    else:
                        inside = (kk >= 0) & (kk < s_len)
                        tap = torch.where(inside, x[k, :, kk.clamp(0, s_len - 1), ww], 0.0)
                    taps.append(tap)
                out[k, :, vv, ww] = (1 - f) * taps[0] + f * taps[1]
    return out, hits, tiles


@pytest.mark.parametrize("w", [524, 792])
@pytest.mark.parametrize("alpha", [None, "neg", 0.0, "steep"], ids=["pos", "neg", "zero", "steep"])
def test_resample_bf16_forward_threads_cover_each_output_once(w, alpha):
    """The bf16 forward's multi-column threads at BagGAN-HQ's two pass widths
    (W = 524: 8-byte rows, the last run of 8 ragged; W = 792: 16-byte rows),
    V = 70 (a ragged second tile of rows), ADA-like intercepts (about half a
    source row per column, as at ADA's draws) off both ends of the source
    column, and a steep alpha whose band outgrows the shared buffer (read
    from the image): each output once, the lerps equal ``_resample_pass``
    bit for bit on the bf16 values, and the JAX pass within 1e-5."""
    b, c, s_len, v_len = 2, 3, 48, 70
    rng = np.random.RandomState(w)
    x = torch.from_numpy(rng.randn(b, c, s_len, w).astype(np.float32)).bfloat16().float()
    a = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    slope = rng.choice([-0.6, 0.5], b)[:, None]
    icpt = (slope * np.arange(w) + rng.rand(b, 1) * s_len - 0.5 * slope * w
            - 0.4 * a[:, None] * v_len).astype(np.float32)
    if alpha == "neg":
        a, icpt = -a, (icpt + 0.8 * v_len).astype(np.float32)
    elif alpha == "steep":
        a, s_len = np.full(b, 3.0, np.float32), 300
        x = torch.from_numpy(rng.randn(b, c, s_len, w).astype(np.float32)).bfloat16().float()
    elif alpha is not None:
        a = np.full(b, alpha, np.float32)
    ours, hits, tiles = _forward_pass_bf16(x, _t(a), _t(icpt), v_len)
    assert bool((hits == 1).all())
    assert tiles["direct" if alpha == "steep" else "staged"] > 0
    plain = taw._resample_pass(x, _t(a), _t(icpt), axis=2, out_len=v_len)
    assert torch.equal(ours, plain)
    want = jawp.resample_rows(jnp.asarray(x.numpy()), jnp.asarray(a), jnp.asarray(icpt), v_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **ADJ_TOL)


def _walk_range(alpha, icpt, s_first, s_last, v_len):
    """csrc/affine_warp.cu walk_range(): the candidate rows [v0, v1] of the
    cotangent for source rows s_first..s_last of a column (the union of
    their ``_window``s); all of [0, V) where alpha = 0 or 1/alpha
    overflows. Broadcasts."""
    inv = 1 / alpha
    full = (alpha == 0) | ~torch.isfinite(inv)
    inv = torch.where(full, 0.0, inv)
    U = torch.floor(icpt)
    e0 = ((s_first - 2).to(torch.float32) - U) * inv
    e1 = ((s_last + 1).to(torch.float32) - U) * inv
    lo = torch.minimum(e0, e1).clamp(-2, v_len + 1)
    hi = torch.maximum(e0, e1).clamp(-2, v_len + 1)
    v0 = (torch.floor(lo).to(torch.int64) - 1).clamp(min=0)
    v1 = (torch.ceil(hi).to(torch.int64) + 1).clamp(max=v_len - 1)
    full = full.expand_as(v0)
    return torch.where(full, 0, v0), torch.where(full, v_len - 1, v1)


def _adjoint_pass_bf16(g, alpha, icpt, s_len):
    """csrc/affine_warp.cu's bf16 adjoint at the wrapper's launch
    (``adjoint_plan``), block by block, its threads at once: thread t of a
    tile takes column t % 32 and ts / 4 consecutive source rows; its walk
    of v (``_walk_range``); the tile's band of cotangent rows reduced from
    the non-empty walks, staged (the tile's columns, zero past W) where all
    channels fit ``BAND_T_SMEM`` bytes, else read from the cotangent (every
    staged read, unchecked in the kernel, checked here to lie in the band);
    the walk in increasing v adding coef_t * g[v] to three slots, rows k0(v)
    + t, that slide with k0 (up for alpha >= 0, down for alpha < 0), a row
    emitted when k0 moves past it or at the walk's end. Returns the emitted
    fp32 sums (before the rounding), how often each (b, s, w) was emitted,
    and how many tiles were staged and not."""
    b, c, v_len, w = g.shape
    (tw, ts), (gx, gy, gz) = trs.adjoint_plan(b, s_len, w, torch.bfloat16)
    threads = trs.BF16_ADJ_THREADS
    r_n = ts * tw // threads
    assert gy <= trs.GRID_MAX and gz <= trs.GRID_MAX and r_n * threads == ts * tw
    out = torch.zeros(b, c, s_len, w)
    hits = torch.zeros(b, s_len, w, dtype=torch.int64)
    tiles = {"staged": 0, "direct": 0}
    for k in range(gz):
        a = alpha[k]
        up = not bool(a < 0)
        step_dir = 1 if up else -1
        for j in range(gy):
            for i in range(gx):
                t = torch.arange(threads)
                ww = i * tw + t % 32
                s0 = j * ts + (t // 32) * r_n
                live = (ww < w) & (s0 < s_len)
                ww, s0 = ww[live], s0[live]
                s_last = torch.clamp(s0 + r_n, max=s_len) - 1
                ic = icpt[k, ww]
                v0, v1 = _walk_range(a, ic, s0, s_last, v_len)
                some = v0 <= v1
                r0 = int(v0[some].min()) if bool(some.any()) else 0
                n_rows = int(v1[some].max()) - r0 + 1 if bool(some.any()) else 0
                staged = c * n_rows * tw * 2 <= trs.BAND_T_SMEM
                tiles["staged" if staged else "direct"] += 1
                if staged:  # rows r0.., zero past W (and outside [0, V))
                    band = torch.zeros(c, n_rows, tw)
                    cols = slice(i * tw, min(i * tw + tw, w))
                    band[:, :, :cols.stop - cols.start] = g[k, :, r0:r0 + n_rows, cols]
                n = len(ww)
                acc = torch.zeros(3, c, n)
                base = s0 - 2 if up else s_last + 2
                done = torch.zeros(n, dtype=torch.bool)

                def emit(m):
                    nonlocal acc, base
                    keep = m & (base >= s0) & (base <= s_last)
                    out[k, :, base[keep], ww[keep]] = acc[0][:, keep]
                    hits[k].index_put_((base[keep], ww[keep]),
                                       torch.ones(int(keep.sum()), dtype=torch.int64),
                                       accumulate=True)
                    shifted = torch.stack([acc[1], acc[2], torch.zeros_like(acc[0])])
                    acc = torch.where(m, shifted, acc)
                    base = torch.where(m, base + step_dir, base)

                span = int((v1 - v0).max()) + 1 if n else 0
                for step in range(max(span, 0)):
                    v = v0 + step
                    active = (v <= v1) & ~done
                    kk0, e1, f = _geometry(a, ic, v.to(torch.float32))
                    skip = (kk0 + 2 < s0) if up else (kk0 > s_last)
                    stop = (kk0 > s_last) if up else (kk0 + 2 < s0)
                    done = done | (active & stop)
                    go = active & ~skip & ~stop
                    while True:
                        m = go & ((base < kk0) if up else (base > kk0 + 2))
                        if not bool(m.any()):
                            break
                        emit(m)
                    one_f = 1 - f
                    cf = [torch.where(e1, 0.0, one_f), torch.where(e1, one_f, f),
                          torch.where(e1, f, 0.0)]
                    if not up:
                        cf = cf[::-1]
                    if staged:  # unchecked, as the kernel reads
                        r = v - r0
                        assert bool(((r[go] >= 0) & (r[go] < n_rows)).all())
                        gv = band[:, r.clamp(0, max(n_rows - 1, 0)), ww - i * tw] \
                            if n_rows else torch.zeros(c, n)
                    else:
                        gv = g[k, :, v.clamp(0, v_len - 1), ww]
                    acc = torch.where(go, acc + torch.stack(cf)[:, None] * gv, acc)
                while True:  # the rows the walk left
                    m = (base <= s_last) if up else (base >= s0)
                    if not bool(m.any()):
                        break
                    emit(m)
    return out, hits, tiles


def _bf16_adjoint_case(w, alpha, c=3):
    """An adjoint case at width ``w``: B = 2, C = ``c``, V = 48 cotangent rows,
    S = 70 source rows (a ragged last tile of 32), ADA-like intercepts
    (about half a source row per column) off both ends of the source
    column, bf16-valued cotangents; ``alpha`` None (positive), "neg",
    "steep" (intercepts climbing 4 rows a column and V = 300: bands over
    the buffer) or a number for every image."""
    b, s_len, v_len = 2, 70, 300 if alpha == "steep" else 48
    rng = np.random.RandomState(w)
    g = torch.from_numpy(rng.randn(b, c, v_len, w).astype(np.float32)).bfloat16().float()
    a = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    slope = rng.choice([-0.6, 0.5], b)[:, None] * (8.0 if alpha == "steep" else 1.0)
    icpt = (slope * np.arange(w) + rng.rand(b, 1) * s_len - 0.5 * slope * w
            - 0.4 * a[:, None] * v_len).astype(np.float32)
    if alpha == "neg":
        a, icpt = -a, (icpt + 0.8 * v_len).astype(np.float32)
    elif alpha not in (None, "steep"):
        a = np.full(b, alpha, np.float32)
    return g, a, icpt, s_len


@pytest.mark.parametrize("w", [524, 792])
@pytest.mark.parametrize("alpha", [None, "neg", 0.0, 1e-40, -1e-40, "steep"],
                         ids=["pos", "neg", "zero", "subnormal", "subnormal_neg", "steep"])
def test_resample_bf16_adjoint_threads_cover_each_output_once(w, alpha):
    """The bf16 adjoint's tiles at BagGAN-HQ's two pass widths (W = 524:
    8-byte rows, the last run of 8 ragged; W = 792: 16-byte rows), S = 70
    (a ragged last tile of rows), alpha positive, negative, 0 and
    subnormal of either sign (every window all of [0, V); below 0 the tap
    index drops by one after v = 0) and steep intercepts whose bands
    outgrow the shared buffer (read from the cotangent): each dx element
    once, every staged read in the band, the fp32 sums equal
    ``_gather_adjoint`` bit for bit on the bf16 values, and the JAX
    adjoint within 1e-5."""
    g, a, icpt, s_len = _bf16_adjoint_case(w, alpha)
    ours, hits, tiles = _adjoint_pass_bf16(g, _t(a), _t(icpt), s_len)
    assert bool((hits == 1).all())
    assert tiles["direct" if alpha == "steep" else "staged"] > 0
    assert torch.equal(ours, _gather_adjoint(g, _t(a), _t(icpt), s_len))
    np.testing.assert_allclose(_np(ours), _np(taw._resample_pass_t(g, _t(a), _t(icpt), s_len)),
                               **ADJ_TOL)
    want = jawp.resample_rows_t(jnp.asarray(g.numpy()), jnp.asarray(a), jnp.asarray(icpt),
                                s_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **ADJ_TOL)


@pytest.mark.parametrize("c", [1, 4, 8])
def test_resample_bf16_adjoint_of_any_channel_count(c):
    """Channel counts other than ADA's 3 at the ragged pass (the kernel
    walks 3 channels at a time, the last group short; at 8 channels some
    bands outgrow the shared buffer): each output once, the sums
    ``_gather_adjoint``'s bit for bit."""
    g, a, icpt, s_len = _bf16_adjoint_case(524, None, c)
    ours, hits, tiles = _adjoint_pass_bf16(g, _t(a), _t(icpt), s_len)
    assert bool((hits == 1).all())
    assert tiles["staged"] > 0
    assert torch.equal(ours, _gather_adjoint(g, _t(a), _t(icpt), s_len))


def _ada_band_rows(alpha, icpt, s_len, v_len):
    """Each tile's band of cotangent rows at one pass of ADA's draws, as
    ``_adjoint_pass_bf16`` reduces it (0 where no window of the tile holds
    a row), the adjoint plan's tiles."""
    b, w = icpt.shape
    (tw, ts), (gx, gy, _) = trs.adjoint_plan(b, s_len, w, torch.bfloat16)
    v0, v1 = _window(alpha, icpt, s_len, v_len)
    ok = v0 <= v1
    pad = (0, gx * tw - w, 0, gy * ts - s_len)
    lo = F.pad(torch.where(ok, v0, 1 << 30), pad, value=1 << 30)
    hi = F.pad(torch.where(ok, v1, -(1 << 30)), pad, value=-(1 << 30))
    lo = lo.reshape(b, gy, ts, gx, tw).amin((2, 4))
    hi = hi.reshape(b, gy, ts, gx, tw).amax((2, 4))
    return (hi - lo + 1).clamp(min=0)


def test_bf16_adjoint_band_fits_at_ada_draws():
    """At the two passes of chip_smoke.py's ADA draw (256^2, B = 20, both
    warp branches and flips; alpha from -1.52 to 1.63) every tile of the
    adjoint plan stages its band: all three channels' rows in its buffer,
    so no tile of the path reads the cotangent from global memory."""
    cs = _chip_smoke()
    _, delta, icpt_v, a, icpt_h, src, out = cs.ada_pass_geometry("cpu")
    for alpha, icpt, s_len, v_len in ((delta, icpt_v, src[0], out[0]),
                                      (a, icpt_h, src[1], out[1])):
        rows = _ada_band_rows(alpha, icpt, s_len, v_len)
        assert 3 * int(rows.max()) * trs.BF16_TILE[0] * 2 <= trs.BAND_T_SMEM


# ---------------------------------------------------------------------------
# the fused act's backward: strided rows, partial sums in a fixed order
# ---------------------------------------------------------------------------


SUM_ROWS = 32  # csrc/fused_act.cu: the column sum's rows of threads


def _fused_act_bwd(g, y, sms, slope=0.2, scale=np.sqrt(2.0)):
    """csrc/fused_act.cu's backward at the wrapper's launch plan, in float32
    numpy: returns dx, db and how often each element was written."""
    rows, c, p = tfa.launch_plan(tfa.KERNEL_BWD, torch.from_numpy(g), sms)
    g2, y2 = g.reshape(rows, c), y.reshape(rows, c)
    slope, scale = np.float32(slope), np.float32(scale)
    dx = np.full((rows, c), np.nan, np.float32)
    hits = np.zeros((rows, c), np.int64)
    part = np.full((p.gx, c), np.nan, np.float32)
    for bx in range(p.gx):
        for by in range(p.gy):
            # each thread's sums, then the block's, in increasing y
            acc = np.zeros((p.ty, p.tx, p.vec), np.float32)
            for j in range(p.ty):
                for i in range(p.tx):
                    c0 = (by * p.tx + i) * p.vec
                    if c0 >= c:
                        continue
                    cs = slice(c0, c0 + p.vec)
                    for r in range(bx * p.ty + j, rows, p.gx * p.ty):
                        d = np.where(y2[r, cs] >= 0, g2[r, cs], g2[r, cs] * slope) * scale
                        dx[r, cs] = d
                        hits[r, cs] += 1
                        acc[j, i] += d
            for i in range(p.tx):
                c0 = (by * p.tx + i) * p.vec
                if c0 >= c:
                    continue
                s = acc[0, i].copy()
                for j in range(1, p.ty):
                    s += acc[j, i]
                part[bx, c0:c0 + p.vec] = s
    # the second launch: thread (x, y) sums rows y, y + 32, ... of its
    # column, then those 32 sums in increasing y
    rowsums = np.zeros((SUM_ROWS, c), np.float32)
    for y_ in range(SUM_ROWS):
        for k in range(y_, p.gx, SUM_ROWS):
            rowsums[y_] += part[k]
    db = rowsums[0].copy()
    for y_ in range(1, SUM_ROWS):
        db += rowsums[y_]
    return dx.reshape(g.shape), db, hits, p


@pytest.mark.parametrize("shape,sms", [((37, 1), 1), ((5, 7, 3), 1), ((33, 12), 2),
                                       ((9, 40), 1), ((3, 1040), 1), ((2, 50, 512), 132)],
                         ids=["c1", "c3", "c12", "c40", "c1040", "c512"])
def test_fused_act_backward_blocks_and_partial_sums(shape, sms):
    """C = 1 and 3 (a channel a thread), 12, 40 and 512 (float4 groups),
    1040 (260 groups: a second block column); few SMs, so that blocks
    stride over several rows and rows are no multiple of a block, and at
    C = 512 one row block per 2 rows, 50 in all, so the column sum's 32
    runs hold one or two partials each."""
    rng = np.random.RandomState(len(shape) + shape[-1])
    g = rng.randn(*shape).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    dx, db, hits, p = _fused_act_bwd(g, y, sms)
    assert (hits == 1).all()
    if shape[-1] == 1040:
        assert p.gy == 2
    if shape[-1] == 512:
        assert p.gx == 50
    want_dx, want_db = tfa.fused_leaky_relu_bwd_ref(torch.from_numpy(g), torch.from_numpy(y))
    np.testing.assert_array_equal(dx, _np(want_dx))
    np.testing.assert_allclose(db, _np(want_dx).reshape(-1, shape[-1]).sum(0), atol=1e-5, rtol=0)
    np.testing.assert_allclose(db, _np(want_db), atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [1, 3, 5, 8, 128, 512, 1040])
def test_fused_act_plan_fits_a_block(c):
    """Every plan's block holds at most 256 threads, covers a row's channel
    groups with its gy block columns, and has at least one row block and
    no more than the rows need."""
    for rows in (1, 7, 300, 1 << 20):
        for sms in (1, 132):
            p = tfa.plan(rows, c, sms)
            assert p.tx * p.ty <= tfa.THREADS and c % p.vec == 0
            assert (p.gy - 1) * p.tx < c // p.vec <= p.gy * p.tx
            assert 1 <= p.gx <= -(-rows // p.ty)


# ---------------------------------------------------------------------------
# the Sinkhorn codes, one read of the scores per iteration
# ---------------------------------------------------------------------------

NEG_INIT = -3e38  # csrc/sinkhorn.cu kNegInit


def _merge(m, s, m2, s2):
    """online_merge: (m, s) and (m2, s2) as one (max, sum of exp(z - max))."""
    mx = torch.maximum(m, m2)
    return mx, s * torch.exp(m - mx) + s2 * torch.exp(m2 - mx)


def _fused_sinkhorn(scores, niters, eps, r, c, nchunks):
    """What csrc/sinkhorn.cu computes. The rows fall into nchunks contiguous
    chunks (one block each on the card); a pass reads each row once: pass 0
    folds x / eps into the column accumulators, passes 1 .. niters - 1 first
    take the row's t = lse_k(x / eps + u) and then fold x / eps + log c - t,
    the last pass writes q = exp(x / eps + u - t). Each chunk's column
    (max, sum) partials merge in chunk order into u = log r - lse."""
    b, k = scores.shape
    inv_eps = torch.tensor(1.0 / eps, dtype=torch.float32)
    rows = -(-b // nchunks)
    starts = range(0, b, rows)

    def one_pass(u, kind):
        m = torch.full((k,), NEG_INIT)
        s = torch.zeros(k)
        q = []
        for b0 in starts:
            z = scores[b0:b0 + rows] * inv_eps  # the chunk's one read
            if kind == "first":
                zc = z
            else:
                t = torch.logsumexp(z + u, dim=1, keepdim=True)
                if kind == "last":
                    q.append(torch.exp(z + u - t))
                    continue
                zc = z + (torch.log(c[b0:b0 + rows, None]) - t)
            cm = zc.max(dim=0).values
            m, s = _merge(m, s, cm, torch.exp(zc - cm).sum(dim=0))
        if kind == "last":
            return torch.cat(q)
        return torch.log(r) - (m + torch.log(s))

    u = torch.zeros(k)
    if niters:
        u = one_pass(u, "first")
        for _ in range(1, niters):
            u = one_pass(u, "mid")
    return one_pass(u, "last")


@pytest.mark.parametrize("niters", [0, 1, 3])
def test_fused_sinkhorn_schedule_matches_jax(niters):
    """B = 200 in 7 chunks of 29 rows (the last 26), K = 37 (no multiple of
    4), eps = 0.05, non-uniform marginals."""
    rng = np.random.RandomState(11 + niters)
    b, k, eps = 200, 37, 0.05
    scores = rng.randn(b, k).astype(np.float32)
    r = rng.rand(k).astype(np.float32) + 0.1
    c = rng.rand(b).astype(np.float32) + 0.1
    r, c = r / r.sum(), c / c.sum()
    ours = _fused_sinkhorn(_t(scores), niters, eps, _t(r), _t(c), nchunks=7)
    assert ours.shape == (b, k)
    want = sinkhorn_knopp_pallas(jnp.asarray(scores), niters, eps, jnp.asarray(r),
                                 jnp.asarray(c), variant="fused")
    np.testing.assert_allclose(_np(ours), np.asarray(want), **SINKHORN_TOL)
    ref = sinkhorn_knopp_ref(_t(scores), niters, eps, _t(r), _t(c))
    np.testing.assert_allclose(_np(ours), _np(ref), **SINKHORN_TOL)
    np.testing.assert_allclose(_np(ours).sum(axis=1), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# the FIR kernel: staged tiles, vertical then horizontal pass, polyphase taps
# ---------------------------------------------------------------------------

SYM6 = np.asarray(ada.SYM6, np.float32)  # ADA's 12 wavelet taps
BLUR = np.array([1, 3, 3, 1], np.float32) / 8


def _gk_upfirdn2d(x, y, B, H, W, C, OH, OW, ux, uy, dx, dy, px0, py0, toh, tow,
                  ct, ih, iw, vec, threads, vpass, taps):
    """csrc/upfirdn2d.cu's C entry, block by block: numpy x (B, H, W, C)
    into y (B, OH, OW, C), every staged index checked to lie in its buffer."""
    assert threads <= 256 and ct % vec == 0 and threads % (ct // vec) == 0
    kh, kw = taps.kh, taps.kw
    ky, kx = np.float32(taps.ky[:kh]), np.float32(taps.kx[:kw])

    def at(buf, i, n):
        assert 0 <= i < n, (i, n)
        return buf[i]

    for b in range(B):
        for c0 in range(0, C, ct):
            cs = slice(c0, min(c0 + ct, C))
            for oy0 in range(0, OH, toh):
                for ox0 in range(0, OW, tow):
                    my0, mx0 = oy0 * dy - py0, ox0 * dx - px0
                    ey, ex = (my0 & 1) * (uy == 2), (mx0 & 1) * (ux == 2)
                    iy0 = (my0 + ey) >> 1 if uy == 2 else my0
                    ix0 = (mx0 + ex) >> 1 if ux == 2 else mx0
                    stage = np.zeros((ih, iw, cs.stop - c0), np.float32)
                    for r in range(ih):
                        for col in range(iw):
                            iy, ix = iy0 + r, ix0 + col
                            if 0 <= iy < H and 0 <= ix < W:
                                stage[r, col] = x[b, iy, ix, cs]
                    mid = stage
                    if vpass:
                        mid = np.zeros((toh, iw, stage.shape[2]), np.float32)
                        for r in range(toh):
                            if uy == 1:
                                rows = [(t, r * dy + t) for t in range(kh)]
                            else:
                                t0 = (ey + r) & 1
                                base = (r + t0 - ey) >> 1
                                rows = [(t, base + j) for j, t in enumerate(range(t0, kh, 2))]
                            for t, i in rows:
                                mid[r] += ky[kh - 1 - t] * at(stage, i, ih)
                    for r in range(min(toh, OH - oy0)):
                        for col in range(min(tow, OW - ox0)):
                            if ux == 1:
                                cols = [(t, col * dx + t) for t in range(kw)]
                            else:
                                t0 = (ex + col) & 1
                                base = (col + t0 - ex) >> 1
                                cols = [(t, base + j) for j, t in enumerate(range(t0, kw, 2))]
                            acc = np.zeros(stage.shape[2], np.float32)
                            for t, i in cols:
                                acc += kx[kw - 1 - t] * at(mid[r], i, iw)
                            y[b, oy0 + r, ox0 + col, cs] = acc


def _fir_kernel_mirror(x, taps_y, taps_x, up, down, pad):
    """The wrapper's launch (``launch_args``: the view, the tile, the folded
    taps) fed to the mirror of the C entry; returns the (B, OH, OW, C)
    output."""
    ty, tx = np.asarray(taps_y, np.float32), np.asarray(taps_x, np.float32)
    spec = tup._Spec(np.outer(ty, tx), (ty, tx), *tup._normalize_args(up, down, pad))
    (ux, uy), (dx, dy), (px0, px1, py0, py1) = spec.up, spec.down, spec.pad
    b, h, w, c = x.shape
    y = torch.full((b, tup.out_size(h, uy, py0, py1, len(ty), dy),
                    tup.out_size(w, ux, px0, px1, len(tx), dx), c), float("nan"))
    xl, yl, args = tup.launch_args(torch.from_numpy(x), y, spec)
    _gk_upfirdn2d(xl.numpy(), yl.numpy(), *args)
    return y.numpy()


def _gk_upfirdn2d_bf16(x, y, B, H, W, C, OH, OW, ux, uy, dx, dy, px0, py0, toh, tow,
                       ct, ih, iw, vec, threads, vpass, taps):
    """csrc/upfirdn2d.cu's bf16 kernel with the C entry's checks, block by
    block in float32 numpy: x (bf16 values) into y (the fp32 sums, before
    the rounding on the store). The vertical pass takes RV rows and the
    horizontal pass CH columns a thread, each reading the staged rows or
    intermediate columns that reach one of them once, in increasing order;
    every index is checked to lie in its buffer and every output's taps
    are counted against the live taps of its row and column. The 4 x 4 blur
    at up = down = 1 and 8 channels a thread takes RV_BLUR rows a thread."""
    kh, kw = taps.kh, taps.kw
    blur = (ux, dx, uy, dy, vec, kh, kw, bool(vpass)) == (1, 1, 1, 1, 8, 4, 4, True)
    rv, ch = tup.RV_BLUR if blur else tup.RV, tup.CH
    assert vec in (1, 4, 8) and C % vec == 0 and ct % vec == 0
    assert threads <= 256 and threads % (ct // vec) == 0
    assert ih >= (-(-((toh - 1) * dy + kh) // uy) if vpass else toh)
    assert iw >= -(-((tow - 1) * dx + kw) // ux)
    assert tup.smem_bf16(ih, iw, toh, ct, vpass) <= 232448
    ky, kx = np.float32(taps.ky[:kh]), np.float32(taps.kx[:kw])

    def at(buf, i, n):
        assert 0 <= i < n, (i, n)
        return buf[i]

    def live(k, u, e, o):  # the taps of output o along one axis
        return list(range(k)) if u == 1 else list(range((e + o) & 1, k, 2))

    for b in range(B):
        for c0 in range(0, C, ct):
            cs = slice(c0, min(c0 + ct, C))
            for oy0 in range(0, OH, toh):
                for ox0 in range(0, OW, tow):
                    my0, mx0 = oy0 * dy - py0, ox0 * dx - px0
                    ey, ex = (my0 & 1) * (uy == 2), (mx0 & 1) * (ux == 2)
                    iy0 = (my0 + ey) >> 1 if uy == 2 else my0
                    ix0 = (mx0 + ex) >> 1 if ux == 2 else mx0
                    stage = np.zeros((ih, iw, cs.stop - c0), np.float32)
                    for r in range(ih):
                        for col in range(iw):
                            iy, ix = iy0 + r, ix0 + col
                            if 0 <= iy < H and 0 <= ix < W:
                                stage[r, col] = x[b, iy, ix, cs]
                    src = stage
                    if vpass:
                        src = np.zeros((toh, iw, stage.shape[2]), np.float32)
                        for r0 in range(0, toh, rv):
                            used = {k: [] for k in range(rv)}
                            i0 = (r0 * dy - ey + uy - 1) // uy
                            i1 = min(ih - 1, ((r0 + rv - 1) * dy + kh - 1 - ey) // uy)
                            for i in range(i0, i1 + 1):
                                row = at(stage, i, ih)
                                for k in range(rv):
                                    t = uy * i + ey - (r0 + k) * dy
                                    if 0 <= t < kh and r0 + k < toh:
                                        src[r0 + k] += ky[kh - 1 - t] * row
                                        used[k].append(t)
                            for k in range(min(rv, toh - r0)):
                                assert used[k] == live(kh, uy, ey, r0 + k), (r0 + k, used[k])
                    for r in range(min(toh, OH - oy0)):
                        for g0 in range(0, tow, ch):
                            if ox0 + g0 >= OW:
                                continue
                            acc = np.zeros((ch, stage.shape[2]), np.float32)
                            used = {k: [] for k in range(ch)}
                            j0 = (g0 * dx - ex + ux - 1) // ux
                            j1 = min(iw - 1, ((g0 + ch - 1) * dx + kw - 1 - ex) // ux)
                            for j in range(j0, j1 + 1):
                                v = at(src[r], j, iw)
                                for k in range(ch):
                                    t = ux * j + ex - (g0 + k) * dx
                                    if 0 <= t < kw:
                                        acc[k] += kx[kw - 1 - t] * v
                                        used[k].append(t)
                            for k in range(ch):
                                if g0 + k < tow and ox0 + g0 + k < OW:
                                    assert used[k] == live(kw, ux, ex, g0 + k), (g0 + k, used[k])
                                    y[b, oy0 + r, ox0 + g0 + k, cs] = acc[k]


def _fir_bf16_mirror(x, taps_y, taps_x, up, down, pad):
    """The wrapper's bf16 launch (``launch_args`` on bf16 tensors: the view,
    the bf16 plan, the folded taps) fed to the mirror of the bf16 kernel;
    returns the (B, OH, OW, C) output rounded once to bf16, as float32."""
    ty, tx = np.asarray(taps_y, np.float32), np.asarray(taps_x, np.float32)
    spec = tup._Spec(np.outer(ty, tx), (ty, tx), *tup._normalize_args(up, down, pad))
    (ux, uy), (dx, dy), (px0, px1, py0, py1) = spec.up, spec.down, spec.pad
    b, h, w, c = x.shape
    y = torch.empty((b, tup.out_size(h, uy, py0, py1, len(ty), dy),
                     tup.out_size(w, ux, px0, px1, len(tx), dx), c), dtype=torch.bfloat16)
    xl, yl, args = tup.launch_args(torch.from_numpy(x).bfloat16(), y, spec)
    lc = xl.shape[3]
    assert args[-4] == (8 if lc % 8 == 0 else 4 if lc % 4 == 0 else 1)  # vec
    sums = torch.full(yl.shape, float("nan"))
    _gk_upfirdn2d_bf16(xl.float().numpy(), sums.numpy(), *args)
    return sums.view(y.shape).bfloat16().float().numpy()


def _bf16_want(x, taps_y, taps_x, up, down, pad):
    """The JAX ``upfirdn2d_ref`` on x's bf16 values, rounded once to bf16."""
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    want = jup.upfirdn2d_ref(jnp.asarray(xb), np.outer(np.float32(taps_y), np.float32(taps_x)),
                             up=up, down=down, pad=pad)
    return torch.from_numpy(np.array(want)).bfloat16().float().numpy()


def _assert_within_a_bf16_step(ours, want):
    """Every output within one bf16 step (2^-7 of its binade) of the
    reference: both round an fp32 sum once, and the sums differ in their
    last fp32 bits only (other summation orders)."""
    assert ours.shape == want.shape
    mag = np.maximum(np.abs(ours), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(ours - want) > step
    assert not bad.any(), (ours[bad][:5], want[bad][:5])


AXES = {"1": (1, 1), "up2": (2, 1), "down2": (1, 2)}


@pytest.mark.parametrize("ax", AXES)
@pytest.mark.parametrize("ay", AXES)
@pytest.mark.parametrize("taps", ["blur", "sym6"])
def test_fir_tiles_match_jax(ax, ay, taps, monkeypatch):
    """Every instantiated (up, down) pair per axis, 4 and 12 taps, at C = 5
    (one thread a channel) and C = 8 (four channels a thread), with a
    negative pad on one side; 3 x 5 output tiles so the image spans ragged
    tiles on both axes."""
    (ux, dx), (uy, dy) = AXES[ax], AXES[ay]
    t = BLUR if taps == "blur" else SYM6
    ty, tx = t * 1.5, t[::-1].copy()
    kh = kw = len(t)
    pad = (kw // 2, -1, kh // 2 - 1, kh // 2)
    plan = tup.plan

    def small(c, kh, kw, up, down, esize=4):
        p = plan(c, kh, kw, up, down, esize)
        return p._replace(toh=3, tow=5, ih=tup._extent(3, kh, up[1], down[1]),
                          iw=tup._extent(5, kw, up[0], down[0]))

    monkeypatch.setattr(tup, "plan", small)
    for c in (5, 8):
        x = np.random.RandomState(c).randn(2, 9, 11, c).astype(np.float32)
        ours = _fir_kernel_mirror(x, ty, tx, (ux, uy), (dx, dy), pad)
        want = jup.upfirdn2d_ref(jnp.asarray(x), np.outer(ty, tx), up=(ux, uy),
                                 down=(dx, dy), pad=pad)
        assert ours.shape == want.shape
        np.testing.assert_allclose(ours, np.asarray(want), **UP_TOL)


@pytest.mark.parametrize("case", ["ada_up_x", "ada_up_y", "ada_down_x",
                                  "ada_down_y", "to_rgb_up", "to_rgb_bwd", "d_blur"])
def test_fir_tiles_at_the_paths_cases_match_jax(case):
    """The paths' cases with the wrapper's own tile and view: ADA's four SYM6
    passes (C = 3; the x passes fold their single vertical tap into taps_x,
    the y passes run their rows as 4-channel columns), the to_rgb skip
    upsample and its backward (down 2, flipped blur, C = 3) and the
    discriminator's blur (C = 40: a 32-channel slice and a ragged one)."""
    n = 12
    blur = 2 * BLUR
    cases = {
        "ada_up_x": ((2, n, n, 3), [1.0], SYM6, (2, 1), (1, 1), (6, 5, 0, 0)),
        "ada_up_y": ((2, n, 2 * n, 3), SYM6, [1.0], (1, 2), (1, 1), (0, 0, 6, 5)),
        "ada_down_x": ((2, 2 * n, 2 * n, 3), [1.0], SYM6[::-1], (1, 1), (2, 1), (-1, -1, 0, 0)),
        "ada_down_y": ((2, 2 * n, n, 3), SYM6[::-1], [1.0], (1, 1), (1, 2), (0, 0, -1, -1)),
        "to_rgb_up": ((2, n, n, 3), blur, blur, (2, 2), (1, 1), (2, 1, 2, 1)),
        "to_rgb_bwd": ((2, 2 * n, 2 * n, 3), blur[::-1], blur[::-1], (1, 1), (2, 2), (1, 1, 1, 1)),
        "d_blur": ((1, 2 * n, 2 * n, 40), BLUR, BLUR, (1, 1), (1, 1), (2, 2, 2, 2)),
    }
    shape, ty, tx, up, down, pad = cases[case]
    x = np.random.RandomState(len(case)).randn(*shape).astype(np.float32)
    want = jup.upfirdn2d_ref(jnp.asarray(x), np.outer(ty, tx), up=up, down=down, pad=pad)
    # the y passes' rows run as 4-channel columns
    view = tup.launch_shape(shape, len(tx), up[0], down[0], pad[:2])
    assert (view[3] == 4) == (case.startswith("ada") and case.endswith("_y"))
    ours = _fir_kernel_mirror(x, ty, tx, up, down, pad)
    np.testing.assert_allclose(ours, np.asarray(want), **UP_TOL)


@pytest.mark.parametrize("ax", AXES)
@pytest.mark.parametrize("ay", AXES)
@pytest.mark.parametrize("taps", ["blur", "sym6"])
def test_fir_bf16_tiles_match_jax(ax, ay, taps, monkeypatch):
    """The bf16 kernel at every instantiated (up, down) pair per axis, 4 and
    12 taps, at C = 3 (one channel a thread) and C = 8 (eight channels a
    thread, 16-byte copies and stores), with a negative pad on one side; 3 x
    5 output tiles, so that the RV-row and CH-column groups are ragged too."""
    (ux, dx), (uy, dy) = AXES[ax], AXES[ay]
    t = BLUR if taps == "blur" else SYM6
    ty, tx = t * 1.5, t[::-1].copy()
    kh = kw = len(t)
    pad = (kw // 2, -1, kh // 2 - 1, kh // 2)
    plan = tup.plan

    def small(c, kh, kw, up, down, esize=4):
        p = plan(c, kh, kw, up, down, esize)
        return p._replace(toh=3, tow=5, ih=tup._extent(3, kh, up[1], down[1]),
                          iw=tup._extent(5, kw, up[0], down[0]))

    monkeypatch.setattr(tup, "plan", small)
    for c in (3, 8):
        x = np.random.RandomState(c).randn(2, 9, 11, c).astype(np.float32)
        ours = _fir_bf16_mirror(x, ty, tx, (ux, uy), (dx, dy), pad)
        _assert_within_a_bf16_step(ours, _bf16_want(x, ty, tx, (ux, uy), (dx, dy), pad))


@pytest.mark.parametrize("case", ["ada_up_x", "ada_up_y", "ada_down_x", "ada_down_y",
                                  "to_rgb_up", "to_rgb_bwd", "d_blur", "d_blur_skip"])
def test_fir_bf16_tiles_at_the_paths_cases_match_jax(case):
    """The bf16 kernel at the paths' cases with the bf16 plan's own tile and
    view: ADA's four SYM6 passes (C = 3; the y passes as 4-channel columns,
    8-byte copies), the to_rgb skip upsample and its backward, and the
    discriminator's blurs at C = 40 (a 32-channel slice and an 8-channel
    one, 16-byte copies and stores) over ragged 8 x 32 tiles."""
    n = 12
    blur = 2 * BLUR
    cases = {
        "ada_up_x": ((2, n, n, 3), [1.0], SYM6, (2, 1), (1, 1), (6, 5, 0, 0)),
        "ada_up_y": ((2, n, 2 * n, 3), SYM6, [1.0], (1, 2), (1, 1), (0, 0, 6, 5)),
        "ada_down_x": ((2, 2 * n, 2 * n, 3), [1.0], SYM6[::-1], (1, 1), (2, 1), (-1, -1, 0, 0)),
        "ada_down_y": ((2, 2 * n, n, 3), SYM6[::-1], [1.0], (1, 1), (1, 2), (0, 0, -1, -1)),
        "to_rgb_up": ((2, n, n, 3), blur, blur, (2, 2), (1, 1), (2, 1, 2, 1)),
        "to_rgb_bwd": ((2, 2 * n, 2 * n, 3), blur[::-1], blur[::-1], (1, 1), (2, 2), (1, 1, 1, 1)),
        "d_blur": ((1, 2 * n - 3, 3 * n + 5, 40), BLUR, BLUR, (1, 1), (1, 1), (2, 2, 2, 2)),
        "d_blur_skip": ((1, 2 * n, 3 * n, 40), BLUR, BLUR, (1, 1), (1, 1), (1, 1, 1, 1)),
    }
    shape, ty, tx, up, down, pad = cases[case]
    x = np.random.RandomState(len(case)).randn(*shape).astype(np.float32)
    view = tup.launch_shape(shape, len(tx), up[0], down[0], pad[:2])
    assert (view[3] == 4) == (case.startswith("ada") and case.endswith("_y"))
    ours = _fir_bf16_mirror(x, ty, tx, up, down, pad)
    _assert_within_a_bf16_step(ours, _bf16_want(x, ty, tx, up, down, pad))


@pytest.mark.parametrize("c", [1, 3, 5, 8, 12, 40, 128, 512])
def test_fir_plan_fits_a_block(c):
    """For every tap count and (up, down) per axis the plan fits the shared
    memory budget, its threads divide into whole channel groups, and its
    staged footprint covers what the tile reads; at 2-byte elements too
    (the bf16 plan: its vector of channels divides C, its budget is
    ``SMEM_MAX_BF16`` and its horizontal pass's column groups of CH give
    every thread a group where the tile allows)."""
    for (ux, dx) in AXES.values():
        for (uy, dy) in AXES.values():
            for kh in (1, 4, 12, 16):
                for kw in (1, 4, 12, 16):
                    for esize, smem_max in ((4, tup.SMEM_MAX), (2, tup.SMEM_MAX_BF16)):
                        p = tup.plan(c, kh, kw, (ux, uy), (dx, dy), esize)
                        assert p.smem <= smem_max
                        assert p.threads <= tup.THREADS and p.threads % (p.ct // p.vec) == 0
                        assert p.ct % p.vec == 0 and p.toh >= 1 and p.tow >= 1
                        assert c % p.vec == 0
                        # the last output's last tap reads staged column iw - 1 at most
                        assert ((p.tow - 1) * dx + kw - 1) // ux < p.iw
                        if p.vpass:
                            assert ((p.toh - 1) * dy + kh - 1) // uy < p.ih
                        if esize == 2:
                            assert p.smem == tup.smem_bf16(p.ih, p.iw, p.toh, p.ct, p.vpass)
                            assert p.vec == (8 if c % 8 == 0 else 4 if c % 4 == 0 else 1)
                            groups = p.toh * -(-p.tow // tup.CH) * (p.ct // p.vec)
                            wider = tup.smem_bf16(p.ih, tup._extent(2 * p.tow, kw, ux, dx),
                                                  p.toh, p.ct, p.vpass)
                            assert (groups >= p.threads or p.tow == 128
                                    or p.toh < (4 if p.vec == 8 else 8)
                                    or wider > tup.SMEM_MAX_BF16)
