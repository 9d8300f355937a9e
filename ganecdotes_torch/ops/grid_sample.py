"""Differentiable bilinear grid sampling, NHWC (port of
ganecdotes_tpu/ops/grid_sample.py): a gather and a lerp, differentiable to
any order by autograd.

Semantics match ``F.grid_sample(align_corners=False, padding_mode='zeros',
mode='bilinear')``: grid coords in [-1, 1], (x, y) order in the last axis.
"""

import torch


def grid_sample_bilinear(x, grid):
    """x: (B, H, W, C); grid: (B, Ho, Wo, 2) with (gx, gy) in [-1, 1]."""
    b, h, w, c = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    # unnormalize, align_corners=False: ix = ((gx + 1) * W - 1) / 2
    ix = ((gx + 1.0) * w - 1.0) / 2.0
    iy = ((gy + 1.0) * h - 1.0) / 2.0
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    ix1, iy1 = ix0 + 1, iy0 + 1
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    batch = torch.arange(b, device=x.device).reshape((b,) + (1,) * (ix.dim() - 1))

    def gather(iy_, ix_):
        valid = (ix_ >= 0) & (ix_ <= w - 1) & (iy_ >= 0) & (iy_ <= h - 1)
        ixc = torch.clamp(ix_, 0, w - 1).to(torch.long)
        iyc = torch.clamp(iy_, 0, h - 1).to(torch.long)
        return x[batch, iyc, ixc] * valid[..., None].to(x.dtype)

    return (gather(iy0, ix0) * (wy0 * wx0)[..., None]
            + gather(iy0, ix1) * (wy0 * wx1)[..., None]
            + gather(iy1, ix0) * (wy1 * wx0)[..., None]
            + gather(iy1, ix1) * (wy1 * wx1)[..., None])
