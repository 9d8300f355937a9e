"""Nearest resizing with torch ``F.interpolate(mode='nearest')`` semantics,
NHWC (port of ganecdotes_tpu/ops/interp.py; bilinear is not ported yet)."""

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
