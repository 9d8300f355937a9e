"""Image resizing with torch ``F.interpolate`` semantics, NHWC (port of
ganecdotes_tpu/ops/interp.py).

Nearest is an index gather; bilinear is two banded matrix products, one per
axis, with the JAX package's ``_bilinear_matrix`` (both ``align_corners``
modes), so the port and the JAX package sum the same two terms per output.
"""

import functools

import numpy as np
import torch


def _nearest_indices(n_in, n_out, device=None):
    """torch nearest: src = floor(dst * n_in / n_out), clamped to n_in - 1.

    Computed on ``device`` in float64, as the JAX package computes it in
    numpy, so no host-to-device copy stalls the stream.
    """
    dst = torch.arange(n_out, dtype=torch.float64, device=device)
    idx = torch.floor(dst * (n_in / n_out)).to(torch.long)
    return idx.clamp_(max=n_in - 1)


def resize_nearest(x, size):
    """(B, h, w, C) -> (B, H, W, C) matching F.interpolate(mode='nearest')."""
    h, w = (size, size) if isinstance(size, int) else size
    _, ih, iw, _ = x.shape
    if (ih, iw) == (h, w):
        return x
    x = x.index_select(1, _nearest_indices(ih, h, x.device))
    return x.index_select(2, _nearest_indices(iw, w, x.device))


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(n_in, n_out, align_corners=False):
    """(n_out, n_in) row-resampling matrix of bilinear interpolation (torch
    semantics): two taps per output row, clamped at the edges."""
    R = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        if align_corners and n_out > 1:
            src = o * (n_in - 1) / (n_out - 1)
        else:
            src = (o + 0.5) * n_in / n_out - 0.5
        src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        R[o, lo] += 1.0 - frac
        R[o, hi] += frac
    return R


def resize_bilinear(x, size, align_corners=False):
    """(B, h, w, C) -> (B, H, W, C) matching F.interpolate(mode='bilinear');
    the identity at equal size."""
    h, w = (size, size) if isinstance(size, int) else size
    _, ih, iw, _ = x.shape
    if (ih, iw) == (h, w):
        return x
    rh = torch.from_numpy(_bilinear_matrix(ih, h, align_corners)).to(x.device, x.dtype)
    rw = torch.from_numpy(_bilinear_matrix(iw, w, align_corners)).to(x.device, x.dtype)
    t = torch.einsum("oh,bhwc->bowc", rh, x)
    return torch.einsum("pw,bowc->bopc", rw, t)
