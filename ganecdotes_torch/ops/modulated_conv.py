"""StyleGAN2's StyledConv bodies: modulated 3x3 conv + the whole epilogue
(port of ganecdotes_tpu/ops/modulated_conv_pallas.py).

    out = lrelu(demod * conv3x3(x * s, W) + nw * noise + bias, 0.2) * sqrt(2)

Each body has two variants on the card, picked from the shape alone
(``variant``; no fallback between them):

* ``"tf32x3"`` (Cout not in ``NARROW_COUTS``: the ffhq widths):
  ``styled_conv3x3`` launches the CUDA kernel of csrc/styled_conv.cu, a
  9-tap implicit GEMM on tensor cores in 3xTF32 with its epilogue;
  ``styled_up_conv3x3`` the two kernels of csrc/styled_up_conv.cu, the
  stride-2 transposed conv as a sub-pixel GEMM with only the 9 taps that
  see data, on the same main loop (csrc/tf32x3.cuh: TMA + wgmma, the
  weights split into their TF32 planes by the C entry), into a scratch
  tensor, then the blur and the epilogue. Their tile plan (``tf32_plan``:
  the tile width, the ring's depth, the tiles and the tap splits) is
  computed here and passed to the C entries, which check it.
* ``"narrow"`` (Cout of 16, 32 or 64: BagGAN's lean width map; the up
  body at 64 only on small inputs, ``variant``):
  csrc/styled_conv_narrow.cu on the fp32 SIMT units, x * s applied while
  staging, W read as HWIO: the non-up body in one launch, the up body as
  the transposed conv's four phase classes into a scratch tensor, then the
  blur and the epilogue.

On bfloat16 activations both bodies run one kernel each, whatever Cout
(csrc/styled_conv.cu's and csrc/styled_up_conv.cu's ``_bf16`` entries, on
the TMA + wgmma main loop of csrc/bf16_wgmma.cuh, counted as
``styled_conv3x3_bf16`` / ``styled_up_conv3x3_bf16``): x * s and W in
bf16, fp32 accumulators and epilogue, one rounding on the store, a tile of
128 pixels by ``tile_n(Cout)`` channels; the up body's T stays float32.
Their tile plan (``bf16_plan``: the tile width, the ring's depth, the TMA
box of a tile's pixels, the grid and the tap splits) is computed here and
passed to the C entries, which check it.
The narrow and 3xTF32 variants are float32 only. demod, noise, the noise
weight and the bias reach the kernel as float32 (the JAX kernel casts them
to fp32 inside, modulated_conv_pallas.py:179-181).

Both take their plain versions only for tensors on the CPU. Where a
gradient can flow they run inside an autograd Function; where none can
(serving, no-grad synthesis) the forward is called directly. Their
backward is the VJP of the plain composite, as the JAX package's
``_bwd`` and ``_up_bwd`` are (modulated_conv_pallas.py:308-314, :554-561):
``styled_conv3x3_ref`` and ``styled_up_conv3x3_xla``, recomputed from the
saved inputs, the latter with its blur on the FIR kernel
(csrc/upfirdn2d.cu). It is first order only (``once_differentiable``): a
path that takes gradients of gradients through the generator (PPL) runs
the composites instead (``styled_up_conv3x3_xla`` with ``fir=upfirdn2d``).
Plain versions:

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

import functools
import math
from collections import namedtuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ganecdotes_torch.nn.layers import conv2d_nhwc, conv2d_transpose_nhwc
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.subpixel_upconv import upsampled_conv2x_blur
from ganecdotes_torch.ops.upfirdn2d import blur_2d, upfirdn2d, upfirdn2d_ref
from ganecdotes_torch.utils import tracing

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
                          blur_kernel=(1, 3, 3, 1), fir=upfirdn2d_ref):
    """The up branch as conv_transpose + demod + 2-pass blur (same math as
    the sub-pixel form, the JAX generator's default path). ``fir`` runs the
    blur: ``upfirdn2d_ref`` (the default, a plain oracle) or the FIR kernel
    ``upfirdn2d``."""
    kh = w.shape[0]
    xm = x * s[:, None, None, :].to(x.dtype)
    out = conv2d_transpose_nhwc(xm, w, stride=2)
    out = out * demod[:, None, None, :].to(out.dtype)
    # blur pad for upsample (ref model.py:293-299): p = (len(k)-2)-(ks-1)
    pk = len(blur_kernel) - 2 - (kh - 1)
    out = blur_2d(out, blur_kernel, pad=((pk + 1) // 2 + 1, pk // 2 + 1),
                  upsample_factor=2, impl=fir)
    out = out + noise_weight.to(out.dtype) * noise.to(out.dtype)
    out = out + bias.to(out.dtype)
    return torch.where(out >= 0, out, 0.2 * out) * SQRT2


def _check(kernel, x, w, s, demod, noise, noise_weight, bias, up):
    """Checks shared by both kernels; the output's (B, OH, OW, Cout). At
    B = 1 a call's host time is its time on the card, so the common case
    tests each tensor in one expression (a CUDA tensor on x's card:
    ``get_device`` is -1 on the CPU) and ``_build.check_tensor`` runs only
    to name what failed. float32 x takes float32 everywhere; bfloat16 x
    takes float32 or bfloat16 for the rest (cast for the launch)."""
    idx = x.get_device() if x.is_cuda else -2  # -2: no tensor passes
    bf16 = x.dtype is torch.bfloat16
    for t in (x, w, s, demod, noise, noise_weight, bias):
        if not (isinstance(t, torch.Tensor) and t.get_device() == idx
                and (t.dtype is torch.float32 or (bf16 and t.dtype is torch.bfloat16))
                and t.is_contiguous() and not t.data_ptr() % 16):
            dtype = _build.kernel_dtype(kernel, x)
            for name, u in zip(("x", "w", "s", "demod", "noise", "noise_weight", "bias"),
                               (x, w, s, demod, noise, noise_weight, bias)):
                want = dtype if name == "x" or not bf16 else (
                    u.dtype if u.dtype in _build.DTYPES else torch.float32)
                _build.check_tensor(kernel, u, name, device=x.device, dtype=want)
    xs, ws = x.shape, w.shape
    if len(xs) != 4 or len(ws) != 4:
        raise ValueError(f"{kernel}: x and w must be 4-D, got {tuple(xs)}, {tuple(ws)}")
    b, h, wd, cin = xs
    cout = ws[3]
    oh, ow = (2 * h, 2 * wd) if up else (h, wd)
    if ws[0] != 3 or ws[1] != 3 or ws[2] != cin:
        raise ValueError(f"{kernel}: w has shape {tuple(ws)}, expected (3, 3, {cin}, Cout)")
    mult = 8 if bf16 else 4  # 16-byte copies of bf16 or float32 channels
    if cin % mult or cout % mult:
        raise ValueError(f"{kernel}: channels must be multiples of {mult}, "
                         f"got {cin}->{cout}")
    if s.shape != (b, cin):
        raise ValueError(f"{kernel}: s has shape {tuple(s.shape)}, expected {(b, cin)}")
    if demod.shape != (b, cout):
        raise ValueError(f"{kernel}: demod has shape {tuple(demod.shape)}, expected {(b, cout)}")
    if bias.shape != (cout,):
        raise ValueError(f"{kernel}: bias has shape {tuple(bias.shape)}, expected {(cout,)}")
    ns = noise.shape
    if len(ns) != 4 or ns[0] not in (1, b) or ns[1] != oh or ns[2] != ow or ns[3] != 1:
        raise ValueError(
            f"{kernel}: noise has shape {tuple(ns)}, expected (1 or {b}, {oh}, {ow}, 1)")
    if noise_weight.numel() != 1:
        raise ValueError(f"{kernel}: noise_weight must be a scalar")
    if b * h * wd * cin >= 2**31 or b * oh * ow * cout >= 2**31:
        raise ValueError(f"{kernel}: x or the output has 2**31 elements or more")
    return b, oh, ow, cout


def tap_splits(m, cout, sms):
    """How many ways csrc/styled_conv.cu's float32 kernel splits its 9 taps
    (1, 3 or 9) for M = m output pixels on ``sms`` SMs (128-pixel tiles,
    ``tf32_tile_n(cout)`` wide)."""
    return grid_splits(-(-m // TF32_BM) * -(-cout // tf32_tile_n(cout)), sms)


def grid_splits(tiles, sms):
    """How many ways a grid of ``tiles`` whole-K tiles splits its 9 taps
    (1, 3 or 9) on ``sms`` SMs. Only a grid of fewer tiles than SMs is
    split, into the fewest waves of whole-K work (the smaller split on a
    tie): a split writes (split, M, Cout) float32 partial sums that a
    second kernel adds up, in split order."""
    if tiles >= sms:
        return 1
    return min((1, 3, 9), key=lambda n: -(-tiles * n // sms) / n)


# Output widths the narrow variant (csrc/styled_conv_narrow.cu) takes.
NARROW_COUTS = (16, 32, 64)
# launches per (kernel, variant), beside _build.LAUNCHES' per-kernel counts
VARIANT_LAUNCHES = {(k, v): 0 for k in ("styled_conv3x3", "styled_up_conv3x3")
                    for v in ("tf32x3", "narrow")}
NARROW_THREADS = 256  # per block, as the kernel's NT
NARROW_MAX_SPLITS = 8  # the kernel's MAX_SPLITS, a portable cluster
_SMS = {}


def variant(cout, up=False, pixels=0, sms=132):
    """The variant a CUDA call runs for ``cout`` output channels and
    ``pixels`` = B * H * W input pixels on ``sms`` SMs: "narrow" for Cout
    in NARROW_COUTS, else "tf32x3"; but the up body at Cout 64 runs the
    3xTF32 GEMMs where their four phase classes of 128-row tiles fill a
    wave of the SMs, which they then do faster (kernel_ab.py --variants)."""
    if cout not in NARROW_COUTS:
        return "tf32x3"
    if up and cout == 64 and 4 * pixels >= 128 * sms:
        return "tf32x3"
    return "narrow"


_SPLITS = {}  # narrow_splits' arguments -> its splits


def narrow_splits(b, h, w, cin, cout, up, sms):
    """How many ways the narrow variant splits its 16-channel chunks for
    input (b, h, w, cin): not at all where its blocks (256 threads of 8
    output channels by 4 pixels, a tile 32 columns wide) fill the SMs;
    else (B = 1) over as many blocks as bring the grid to two per SM, at
    most one chunk a split and NARROW_MAX_SPLITS (a tile's splits form
    one cluster)."""
    rows = 4 * (NARROW_THREADS // (cout // 8) // 32)
    if up:  # the transposed conv's four classes over (h + 1) x (w + 1)
        h, w = h + 1, w + 1
    blocks = b * -(-h // rows) * -(-w // 32) * (4 if up else 1)
    if blocks >= sms:
        return 1
    return min(-(-cin // 16), NARROW_MAX_SPLITS, -(-2 * sms // blocks))


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _narrow_forward(kernel, x, w, s, demod, noise, noise_weight, bias, up,
                    taps=(0.0, 0.0, 0.0, 0.0), nsplit=None):
    """csrc/styled_conv_narrow.cu's C entry (one launch, the up body two);
    ``nsplit`` overrides ``narrow_splits`` (for measuring the choice)."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    f = 2 if up else 1
    if b * h * wd * cout == 0:
        return x.new_empty((b, f * h, f * wd, cout))
    if nsplit is None:
        key = (b, h, wd, cin, cout, up, x.device)
        nsplit = _SPLITS.get(key)
        if nsplit is None:
            nsplit = _SPLITS[key] = narrow_splits(b, h, wd, cin, cout, up,
                                                  _sm_count(x.device))
    if up:  # one allocation: the output, then the transposed conv's T
        n_out = b * 2 * h * 2 * wd * cout
        buf = x.new_empty(n_out + b * (2 * h + 1) * (2 * wd + 1) * cout)
        out = buf[:n_out].view(b, 2 * h, 2 * wd, cout)
        t = buf.data_ptr() + 4 * n_out
    else:
        out, t = x.new_empty((b, h, wd, cout)), None
    _build.launch(
        kernel, "gk_styled_conv3x3_narrow",
        x.data_ptr(), w.data_ptr(), s.data_ptr(), demod.data_ptr(),
        noise.data_ptr(), 0 if noise.shape[0] == 1 else f * h * f * wd,
        noise_weight.data_ptr(), bias.data_ptr(), out.data_ptr(), t, nsplit,
        b, h, wd, cin, cout, int(up), *taps, _build.stream_of(x),
    )
    VARIANT_LAUNCHES[(kernel, "narrow")] += 1
    return out


# csrc/bf16_wgmma.cuh's constants: 128- or 256-row tiles (two consumer
# warpgroups of one or two m64 blocks), 64 channels a stage (one 128-byte
# swizzled row), a ring of at most 6 stages in the 227 KB a block may use,
# after 1024 bytes of alignment slack, 16 bytes of barriers a stage and a
# row table of 256 16-byte entries.
BF16_BMS = (128, 256)
BF16_BK = 64
BF16_SMEM_LIMIT = 232448
BF16_MAX_STAGES = 6
BF16_BOX_MAX = 256  # TMA's largest box side


def tile_n(cout):
    """The bf16 kernels' tile width for ``cout`` channels (csrc/bf16_wgmma.cuh
    ``tile_n``): the smallest of 16, 32, 64 and 128 that holds them, else
    256."""
    return (16 if cout <= 16 else 32 if cout <= 32 else 64 if cout <= 64
            else 128 if cout <= 128 else 256)


def pixel_box(b, h, w, bm=128):
    """The non-up bf16 body's TMA box of a tile's ``bm`` pixels (tw, th,
    nb): 64 columns (W >= 64) or whole rows, as many rows as make bm
    pixels, and where the rows are whole images, as many images: at 128,
    64 x 2, 32 x 4, 16 x 8, 8 x 8 x 2, 4 x 4 x 8 at the StyleGAN widths. A
    box of fewer than bm pixels (ragged widths) leaves the tile's last rows
    unused."""
    tw = min(w, 64)
    th = min(h, bm // tw)
    nb = min(b, bm // (tw * th)) if th == h else 1
    return tw, th, nb


def tile_m(bn, m, sms=132):
    """The bf16 kernels' tile rows for ``m`` output pixels (or up-body
    positions) at tile width ``bn``: 256 where the tile is at most 128 wide
    (two m64 blocks a consumer warpgroup: 128 accumulators a thread at
    most) and 256-row tiles still make two waves of the SMs, else 128. A
    taller tile reads B once for twice the rows, from L2 as from memory."""
    return 256 if bn <= 128 and m >= 2 * sms * 256 else 128


def bf16_ring(bm, bn):
    """csrc/bf16_wgmma.cuh's ring for a bm x bn tile: (stages, bytes a
    stage, the block's dynamic shared memory)."""
    stage_bytes = 2 * BF16_BK * (bm + bn)
    fixed = 1024 + 16 * max(BF16_BMS)  # alignment slack, the row table
    stages = min(BF16_MAX_STAGES,
                 (BF16_SMEM_LIMIT - fixed - 16 * BF16_MAX_STAGES) // stage_bytes)
    return stages, stage_bytes, fixed + stages * (stage_bytes + 16)


# The tile plan of either wgmma main loop (``bf16_plan``, ``tf32_plan``).
WgmmaPlan = namedtuple("WgmmaPlan", [
    "bm",           # tile rows (pixels or positions)
    "bn",           # tile width (output channels)
    "stages",       # the ring's depth
    "stage_bytes",  # one stage: bm rows of A and bn rows of B (tf32: its two planes), 128 B each
    "smem_bytes",   # the block's dynamic shared memory
    "chunks",       # stages a tap: 64 bf16 or 32 float32 channels each
    "mode",         # A's TMA mode: "tile" (bf16 non-up) or "im2col"
    "box",          # A's box, innermost first: (64, tw, th, nb) or (channels, bm)
    "tiles",        # tile: (x, y, image) tiles; im2col: (tiles,) a class
    "tiles_m",      # bm-row tiles (a class's, up)
    "tiles_n",      # bn-wide tiles
    "nsplit",       # tap splits (non-up; 1 up)
    "blocks",       # the grid: tiles_m * tiles_n * nsplit (times 4 classes, up)
])


@functools.lru_cache(maxsize=None)
def bf16_plan(b, h, w, cin, cout, up, sms=132):
    """The bf16 kernels' plan for input (b, h, w, cin) and ``cout`` output
    channels on ``sms`` SMs (csrc/bf16_wgmma.cuh, csrc/styled_conv.cu,
    csrc/styled_up_conv.cu). Non-up: tiles of ``pixel_box`` pixels over the
    (b, h, w) grid, A by a tiled box at each tap's shifted coordinates; a
    grid of fewer tiles than SMs splits its taps (``grid_splits``). Up:
    every phase class walks the (h + 1) x (w + 1) positions of each image
    flat, bm a tile, A by TMA's im2col mode."""
    bn = tile_n(cout)
    m = b * (h + 1) * (w + 1) if up else b * h * w
    bm = tile_m(bn, m, sms)
    stages, stage_bytes, smem = bf16_ring(bm, bn)
    chunks, tiles_n = -(-cin // BF16_BK), -(-cout // bn)
    if up:
        tiles_m = -(-m // bm)
        return WgmmaPlan(bm, bn, stages, stage_bytes, smem, chunks, "im2col",
                        (BF16_BK, bm), (tiles_m,), tiles_m, tiles_n, 1,
                        4 * tiles_m * tiles_n)
    tw, th, nb = pixel_box(b, h, w, bm)
    tiles = (-(-w // tw), -(-h // th), -(-b // nb))
    tiles_m = tiles[0] * tiles[1] * tiles[2]
    nsplit = grid_splits(tiles_m * tiles_n, sms)
    return WgmmaPlan(bm, bn, stages, stage_bytes, smem, chunks, "tile",
                    (BF16_BK, tw, th, nb), tiles, tiles_m, tiles_n, nsplit,
                    tiles_m * tiles_n * nsplit)


# csrc/tf32x3.cuh's constants: 128-row tiles (two consumer warpgroups of
# one m64 block), 32 float32 channels a stage (one 128-byte swizzled row),
# A and B's two TF32 planes a stage, a ring of at most 6 stages in the same
# 227 KB and fixed bytes as the bf16 loop's.
TF32_BM = 128
TF32_BK = 32
TF32_MAX_STAGES = 6


def tf32_tile_n(cout):
    """The float32 GEMMs' tile width for ``cout`` channels (csrc/tf32x3.cuh
    ``tile_n``): 32 or 64 where that holds them, else 128 (the running and
    the partial sums take 128 accumulators a thread there)."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 128


def tf32_ring(bn):
    """csrc/tf32x3.cuh's ring for a 128 x bn tile: (stages, bytes a stage,
    the block's dynamic shared memory)."""
    stage_bytes = 4 * TF32_BK * (TF32_BM + 2 * bn)
    fixed = 1024 + 16 * max(BF16_BMS)  # alignment slack, the row table
    stages = min(TF32_MAX_STAGES,
                 (BF16_SMEM_LIMIT - fixed - 16 * TF32_MAX_STAGES) // stage_bytes)
    return stages, stage_bytes, fixed + stages * (stage_bytes + 16)


@functools.lru_cache(maxsize=None)
def tf32_plan(b, h, w, cin, cout, up, sms=132):
    """The float32 GEMMs' plan for input (b, h, w, cin) and ``cout`` output
    channels on ``sms`` SMs (csrc/tf32x3.cuh, csrc/styled_conv.cu,
    csrc/styled_up_conv.cu): 128-row tiles walking the body's grid flat by
    TMA's im2col mode, the (b, h, w) pixels (non-up) or every phase class
    over the (h + 1) x (w + 1) positions of each image (up), by
    ``tf32_tile_n(cout)`` channels; a non-up grid of fewer tiles than SMs
    splits its taps (``grid_splits``)."""
    bn = tf32_tile_n(cout)
    m = b * (h + 1) * (w + 1) if up else b * h * w
    stages, stage_bytes, smem = tf32_ring(bn)
    chunks, tiles_n = -(-cin // TF32_BK), -(-cout // bn)
    tiles_m = -(-m // TF32_BM)
    nsplit = 1 if up else tap_splits(m, cout, sms)
    return WgmmaPlan(TF32_BM, bn, stages, stage_bytes, smem, chunks, "im2col",
                     (TF32_BK, TF32_BM), (tiles_m,), tiles_m, tiles_n, nsplit,
                     (4 if up else nsplit) * tiles_m * tiles_n)


def _bf16_operands(kernel, x, w, s, demod, noise, noise_weight, bias):
    """The bf16 C entries' operands: x * s (in bf16, as the JAX kernel
    rounds it) and W as (3, 3, Cout, Cin) bf16; demod, noise, the noise
    weight and the bias as float32."""
    xm = x * s[:, None, None, :].to(x.dtype)
    w_nk = w.permute(0, 1, 3, 2).to(torch.bfloat16,
                                    memory_format=torch.contiguous_format).contiguous()
    rest = [t.to(torch.float32).contiguous() for t in (demod, noise, noise_weight, bias)]
    for name, t in zip(("demod", "noise", "noise_weight", "bias"), rest):
        _build.check_tensor(kernel, t, name, device=x.device)
    return (xm, w_nk, *rest)


def _bf16_conv_forward(x, w, s, demod, noise, noise_weight, bias, out_shape):
    kernel = "styled_conv3x3_bf16"
    b, oh, ow, cout = out_shape
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    xm, w_nk, demod, noise, nw, bias = _bf16_operands(
        kernel, x, w, s, demod, noise, noise_weight, bias)
    plan = bf16_plan(*x.shape, cout, False, _sm_count(x.device))
    part = None
    if plan.nsplit > 1:
        part = torch.empty((plan.nsplit, b * oh * ow, cout), dtype=torch.float32,
                           device=x.device)
    _build.launch(
        kernel, "gk_styled_conv3x3_bf16",
        xm.data_ptr(), w_nk.data_ptr(), demod.data_ptr(), noise.data_ptr(),
        0 if noise.shape[0] == 1 else oh * ow, nw.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), plan.nsplit,
        *x.shape, cout, plan.bm, plan.bn, plan.stages, *plan.box[1:],
        _build.stream_of(x),
    )
    return out


def _conv_forward(x, w, s, demod, noise, noise_weight, bias):
    if x.is_cpu:
        return styled_conv3x3_ref(x, w, s, demod, noise, noise_weight, bias)
    kernel = "styled_conv3x3"
    b, oh, ow, cout = _check(kernel, x, w, s, demod, noise, noise_weight,
                             bias, up=False)
    if x.dtype is torch.bfloat16:
        return _bf16_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                  (b, oh, ow, cout))
    if variant(cout) == "narrow":
        return _narrow_forward(kernel, x, w, s, demod, noise, noise_weight,
                               bias, up=False)
    return _tf32x3_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                (b, oh, ow, cout))


def _tf32x3_conv_forward(x, w, s, demod, noise, noise_weight, bias, out_shape):
    kernel = "styled_conv3x3"
    b, oh, ow, cout = out_shape
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # the modulation x * s is materialised here, as the JAX kernel does
    xm = x * s[:, None, None, :]
    cin = x.shape[3]
    plan = tf32_plan(*x.shape, cout, False, _sm_count(x.device))
    # the weights' TF32 planes (2, 9, Cout, Cin), written by the C entry
    planes = torch.empty((2, 9, cout, cin), dtype=x.dtype, device=x.device)
    part = None
    if plan.nsplit > 1:
        part = torch.empty((plan.nsplit, b * oh * ow, cout), dtype=x.dtype, device=x.device)
        _build.check_tensor(kernel, part, "scratch")
    _build.launch(
        kernel, "gk_styled_conv3x3",
        _build.ptr(xm), _build.ptr(w), _build.ptr(planes), _build.ptr(demod),
        _build.ptr(noise), 0 if noise.shape[0] == 1 else oh * ow,
        _build.ptr(noise_weight), _build.ptr(bias), _build.ptr(out),
        None if part is None else _build.ptr(part), plan.nsplit, *x.shape, cout,
        plan.bn, plan.stages, plan.tiles_m, _build.stream_of(x),
    )
    VARIANT_LAUNCHES[(kernel, "tf32x3")] += 1
    return out


_TAPS = {}  # 1-D blur -> its taps: numpy costs microseconds a call


def _blur_taps(kernel, blur_kernel):
    """The separable 1-D taps of ``make_kernel(blur_kernel, gain=4)``:
    2 * k / sum(k), float32."""
    key = tuple(blur_kernel)
    taps = _TAPS.get(key)
    if taps is None:
        k = np.asarray(key, np.float32)
        if k.shape != (4,):
            raise ValueError(
                f"{kernel}: the kernel takes a 1-D blur of 4 taps, got {blur_kernel}")
        taps = _TAPS[key] = [float(t) for t in np.float32(2.0) * k / k.sum()]
    return taps


def _up_conv_forward(x, w, s, demod, noise, noise_weight, bias, blur_kernel):
    if x.is_cpu:
        return styled_up_conv3x3_ref(x, w, s, demod, noise, noise_weight,
                                     bias, blur_kernel)
    kernel = "styled_up_conv3x3"
    taps = _blur_taps(kernel, blur_kernel)
    b, oh, ow, cout = _check(kernel, x, w, s, demod, noise, noise_weight,
                             bias, up=True)
    if x.dtype is torch.bfloat16:
        return _bf16_up_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                     taps, (b, oh, ow, cout))
    if variant(cout, True, b * oh * ow // 4, _sm_count(x.device)) == "narrow":
        return _narrow_forward(kernel, x, w, s, demod, noise, noise_weight,
                               bias, up=True, taps=taps)
    return _tf32x3_up_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                   taps, (b, oh, ow, cout))


def _tf32x3_up_conv_forward(x, w, s, demod, noise, noise_weight, bias, taps,
                            out_shape):
    kernel = "styled_up_conv3x3"
    b, oh, ow, cout = out_shape
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # demod * conv_transpose, (B, 2H+1, 2W+1, Cout), before the blur
    scratch = torch.empty((b, oh + 1, ow + 1, cout), dtype=x.dtype,
                          device=x.device)
    _build.check_tensor(kernel, scratch, "scratch")
    xm = x * s[:, None, None, :]
    cin = x.shape[3]
    plan = tf32_plan(*x.shape, cout, True, _sm_count(x.device))
    # the weights' TF32 planes (2, 9, Cout, Cin), written by the C entry
    planes = torch.empty((2, 9, cout, cin), dtype=x.dtype, device=x.device)
    _build.launch(
        kernel, "gk_styled_up_conv3x3",
        _build.ptr(xm), _build.ptr(w), _build.ptr(planes), _build.ptr(demod),
        _build.ptr(noise), 0 if noise.shape[0] == 1 else oh * ow,
        _build.ptr(noise_weight), _build.ptr(bias), _build.ptr(scratch),
        _build.ptr(out), *x.shape, cout, *taps, plan.bn, plan.stages,
        plan.tiles_m, _build.stream_of(x),
    )
    VARIANT_LAUNCHES[(kernel, "tf32x3")] += 1
    return out


def _bf16_up_conv_forward(x, w, s, demod, noise, noise_weight, bias, taps,
                          out_shape):
    kernel = "styled_up_conv3x3_bf16"
    b, oh, ow, cout = out_shape
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    xm, w_nk, demod, noise, nw, bias = _bf16_operands(
        kernel, x, w, s, demod, noise, noise_weight, bias)
    # demod * conv_transpose, (B, 2H+1, 2W+1, Cout), float32: the blur and
    # the epilogue read the unrounded sums
    scratch = torch.empty((b, oh + 1, ow + 1, cout), dtype=torch.float32,
                          device=x.device)
    plan = bf16_plan(*x.shape, cout, True, _sm_count(x.device))
    _build.launch(
        kernel, "gk_styled_up_conv3x3_bf16",
        xm.data_ptr(), w_nk.data_ptr(), demod.data_ptr(), noise.data_ptr(),
        0 if noise.shape[0] == 1 else oh * ow, nw.data_ptr(), bias.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), *x.shape, cout, *taps, plan.bm,
        plan.bn, plan.stages, plan.tiles_m, _build.stream_of(x),
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


def _up_conv_composite(*args):
    """``styled_up_conv3x3_xla`` with its blur on the FIR kernel (on CUDA
    tensors): the composite the up kernel's backward differentiates."""
    return styled_up_conv3x3_xla(*args, fir=upfirdn2d)


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
        return _composite_vjp(ctx, _up_conv_composite, g,
                              ctx.blur_kernel) + (None,)


def _needs_graph(x, w, s, demod, noise, noise_weight, bias):
    return torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad or s.requires_grad or demod.requires_grad
        or noise.requires_grad or noise_weight.requires_grad or bias.requires_grad)


def styled_conv3x3(x, w, s, demod, noise, noise_weight, bias):
    """Non-up StyledConv body: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; first-order differentiable. The span
    ``ops.styled_conv3x3`` holds the whole layer: the wrapper's passes and
    the kernel."""
    with tracing.span("ops.styled_conv3x3"):
        if _needs_graph(x, w, s, demod, noise, noise_weight, bias):
            return _StyledConv3x3.apply(x, w, s, demod, noise, noise_weight, bias)
        return _conv_forward(x, w, s, demod, noise, noise_weight, bias)


def styled_up_conv3x3(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """Upsampling StyledConv body (2x): the CUDA kernels on CUDA tensors
    (a 1-D ``blur_kernel`` of 4 taps), the plain sub-pixel version on CPU
    tensors; first-order differentiable. Its span is
    ``ops.styled_up_conv3x3``."""
    blur_kernel = tuple(blur_kernel)
    with tracing.span("ops.styled_up_conv3x3"):
        if _needs_graph(x, w, s, demod, noise, noise_weight, bias):
            return _StyledUpConv3x3.apply(x, w, s, demod, noise, noise_weight, bias,
                                          blur_kernel)
        return _up_conv_forward(x, w, s, demod, noise, noise_weight, bias,
                                blur_kernel)
