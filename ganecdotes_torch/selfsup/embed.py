"""Per-pixel feature embedding (port of ganecdotes_tpu/selfsup/embed.py,
nearest interpolation only).

The projection's first linear layer splits by pyramid level,
``z(p) = sum_l W_l . f_l(src_l(p))``; nearest interpolation commutes with
the channel-wise matmul, so each term is computed at its native resolution
and only the nclasses-wide result is upsampled and summed
(``project_feature_maps``). ``pixel_feature_maps`` keeps the explicit
upsample + concat form as the oracle. The folded ``project_segment_fcn``
(head conv folded into the pyramid) is not ported yet: the server runs the
unfused form, projection then head.

For the SwAV step, ``project_gathered`` projects only a subset of pixels:
per level it gathers the picked pixels' features, then multiplies, so the
weight's gradient is the dense product gᵀ·dz and no scatter-add is needed.
"""

import torch

from ganecdotes_torch.ops.interp import _nearest_indices, resize_nearest


def layer_channel_dims(features):
    return [int(f.shape[-1]) for f in features]


def pixel_feature_maps(features, hlen=None, interp="nearest"):
    """Explicit upsample + concat (B, H, W, sum c)[..., :hlen]."""
    if interp != "nearest":
        raise NotImplementedError(f"interp={interp!r} is not ported yet")
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    out = torch.cat([resize_nearest(f, (h, w)) for f in features], dim=-1)
    if hlen is not None:
        out = out[..., :hlen]
    return out


def _split_weight_by_layer(weight, channel_dims, hlen=None):
    """(offset, usable channels) per level of the (hlen, out) weight.

    ``hlen`` may cut the concat mid-level (the reference slices channels
    [:hlen]); levels past the cut get zero usable channels.
    """
    return _level_chunks(channel_dims,
                         weight.shape[0] if hlen is None else hlen)


def _level_chunks(channel_dims, total):
    chunks = []
    off = 0
    for c in channel_dims:
        use = max(0, min(c, total - off))
        chunks.append((off, use))
        off += c
    return chunks


def project_feature_maps(features, weight, hlen=None, interp="nearest"):
    """pixel_feature_maps(features, hlen) @ weight, level-decomposed.

    features: list of (B, h, w, c) NHWC maps; weight: (sum c or hlen, out).
    The accumulator is upsampled coarse to fine (integer-factor nearest
    upsamples compose exactly), so only one full-resolution temporary exists.
    """
    if interp != "nearest":
        raise NotImplementedError(f"interp={interp!r} is not ported yet")
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    chunks = _split_weight_by_layer(weight, layer_channel_dims(features), hlen)
    acc = None
    for f, (off, use) in zip(features, chunks):
        if use == 0:
            continue
        z = f[..., :use] @ weight[off : off + use].to(f.dtype)
        if acc is None:
            acc = z
            continue
        ah, aw = acc.shape[1], acc.shape[2]
        fh, fw = z.shape[1], z.shape[2]
        if (fh, fw) != (ah, aw):
            if fh % ah == 0 and fw % aw == 0:
                acc = resize_nearest(acc, (fh, fw))
            else:  # non-nested pyramid: upsample both straight to full res
                acc = resize_nearest(acc, (h, w))
                z = resize_nearest(z, (h, w))
        acc = acc + z
    return resize_nearest(acc, (h, w))


def _gather_levels(features, picks, out_hw, chunks):
    """Per level with usable channels: (offset, use, (B, N, use) gather)."""
    h, w = out_hw
    ys = torch.div(picks, w, rounding_mode="floor")
    xs = picks % w
    for f, (off, use) in zip(features, chunks):
        if use == 0:
            continue
        ri = _nearest_indices(f.shape[1], h, f.device)[ys]
        ci = _nearest_indices(f.shape[2], w, f.device)[xs]
        yield off, use, f[:, ri, ci, :use]


def pixel_feature_gather(features, picks, out_hw, hlen=None):
    """The full concat feature vectors (B, N, sum c[:hlen]) of the pixels at
    flat row-major indices ``picks`` (N,) into the (H, W) grid."""
    dims = layer_channel_dims(features)
    chunks = _level_chunks(dims, sum(dims) if hlen is None else hlen)
    return torch.cat([g for _, _, g in _gather_levels(features, picks, out_hw,
                                                      chunks)], dim=-1)


def project_gathered(features, picks, out_hw, weight, hlen=None):
    """sum_l gather_l(picks) @ W_l = pixel_feature_gather(...) @ weight,
    without the (N, hlen) concat. Returns (B, N, out)."""
    chunks = _split_weight_by_layer(weight, layer_channel_dims(features), hlen)
    out = None
    for off, use, g in _gather_levels(features, picks, out_hw, chunks):
        z = g @ weight[off : off + use].to(g.dtype)
        out = z if out is None else out + z
    return out
