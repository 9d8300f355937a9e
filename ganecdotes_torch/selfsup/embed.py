"""Per-pixel feature embedding (port of ganecdotes_tpu/selfsup/embed.py).

The projection's first linear layer splits by pyramid level,
``z(p) = sum_l W_l . f_l(src_l(p))``; nearest and bilinear interpolation
both commute with the channel-wise matmul, so each term is computed at its
native resolution and only the nclasses-wide result is upsampled and summed
(``project_feature_maps``). ``pixel_feature_maps`` keeps the explicit
upsample + concat form as the oracle. The folded forms below are for
nearest interpolation only, as in the JAX package.

Serving folds the head's first conv into that sum as well
(``project_segment_fcn``; ``concat_segment_fcn`` for RepurposeGAN's raw
concat features, where the conv's input-channel slices split by level): the
conv distributes over the levels and
composes with nearest up-f sampling into one polyphase conv per source
resolution (``_polyphase_conv3x3_up``), so the (B, H, W, nclasses)
embedding never exists. The projections are ``torch.matmul``, as the JAX
package computes them outside any Pallas kernel; so are the folded 3x3
convs (``_conv3x3``: one matmul over the 9 taps, then 9 shifted adds).
``F.conv2d`` computes the same function, but for the 64^2 polyphase conv of
the ffhq-256 request (512 -> 192 channels, float32) cuDNN's heuristic takes
an FFT whose workspace runs to GiBs, several times slower than the matmul
form (chip_smoke.py's phase 4 measures both; PERF.md).

For the SwAV step, ``project_gathered`` projects only a subset of pixels:
per level it gathers the picked pixels' features, then multiplies, so the
weight's gradient is the dense product gᵀ·dz and no scatter-add is needed.
"""

import torch

from ganecdotes_torch.nn.layers import conv2d_dilated_nhwc, leaky_relu
from ganecdotes_torch.ops.interp import (
    _nearest_indices,
    resize_bilinear,
    resize_nearest,
)


def layer_channel_dims(features):
    return [int(f.shape[-1]) for f in features]


def pixel_feature_maps(features, hlen=None, interp="nearest", n_layers=None):
    """Explicit upsample (``interp`` 'nearest' or 'bilinear') + concat
    (B, H, W, sum c)[..., :hlen] of the first ``n_layers`` maps (all by
    default)."""
    if n_layers is not None:
        features = features[:n_layers]
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    resize = resize_nearest if interp == "nearest" else resize_bilinear
    out = torch.cat([resize(f, (h, w)) for f in features], dim=-1)
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
    Nearest: the accumulator is upsampled coarse to fine (integer-factor
    nearest upsamples compose exactly), so only one full-resolution
    temporary exists. Bilinear: each level's projection is upsampled to
    full resolution and summed, as the JAX package sums them.
    """
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    chunks = _split_weight_by_layer(weight, layer_channel_dims(features), hlen)
    if interp != "nearest":
        out = None
        for f, (off, use) in zip(features, chunks):
            if use == 0:
                continue
            z = resize_bilinear(f[..., :use] @ weight[off : off + use].to(f.dtype),
                                (h, w))
            out = z if out is None else out + z
        return out
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


def project_segment_single_conv(features, weight, head_w, head_b, hlen=None):
    """Logits of one 3x3 conv over the level-decomposed embedding, without
    the (B, H, W, nclasses) embedding:

        conv3x3(sum_l U_fl(f_l . P_l), W)
          = sum_{full-res l} conv3x3(f_l, P_l . W)
          + sum_{coarse res r} polyphase_up_{H/r}(sum_{l at r} f_l . P_l, W)

    The coarse levels are projected and summed up to the H/4 cutoff (one
    polyphase conv for them all); a level above the cutoff has the
    projection folded into its polyphase weights, unless the static FLOP
    guard finds the projected form cheaper (a very wide output head).

    ``weight``: (hlen, nclasses) projection; ``head_w``: (3, 3, nclasses,
    C_out) HWIO; ``head_b``: (C_out,). Returns (B, H, W, C_out) logits.
    """
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    chunks = _split_weight_by_layer(weight, layer_channel_dims(features), hlen)

    full, coarse = [], []
    for f, (off, use) in zip(features, chunks):
        if use == 0:
            continue
        (full if f.shape[1] == h and f.shape[2] == w else coarse).append(
            (f, off, use))

    out = None
    # full-resolution levels: the projection folded into the conv weights
    for f, off, use in full:
        wc = torch.einsum("cd,tsdo->tsco", weight[off : off + use], head_w)
        y = _conv3x3(f[..., :use], wc)
        out = y if out is None else out + y

    cutoff = h // 4
    d_proj = head_w.shape[2]
    co = head_w.shape[3]
    groups = {}  # source resolution -> summed (B, r, rw, nclasses) projection
    hi = {}  # source resolution above the cutoff -> [(feature, offset, use)]
    for f, off, use in coarse:
        r = f.shape[1]
        if r > cutoff:
            hi.setdefault(r, []).append((f, off, use))
            continue
        z = f[..., :use] @ weight[off : off + use].to(f.dtype)
        groups[r] = groups[r] + z if r in groups else z
    for r, levels in list(hi.items()):
        f_up = h // r
        fold = sum(9 * use * f_up * f_up * co for _, _, use in levels)
        proj = (sum(use * d_proj for _, _, use in levels)
                + 9 * d_proj * f_up * f_up * co)
        if fold > proj:  # wide-output head: the projected form is cheaper
            del hi[r]
            for f, off, use in levels:
                z = f[..., :use] @ weight[off : off + use].to(f.dtype)
                groups[r] = groups[r] + z if r in groups else z
    if groups:
        acc = None
        for r in sorted(groups):
            if r > cutoff:
                break
            z = groups.pop(r)
            if acc is not None:
                if acc.shape[1] != r:
                    acc = resize_nearest(acc, (r, z.shape[2]))
                acc = acc + z
            else:
                acc = z
        if acc is not None:
            # acc holds resolutions <= cutoff only, and a cutoff-resolution
            # group was popped into it, so this never collides
            if acc.shape[1] != cutoff:
                acc = resize_nearest(acc, (cutoff, cutoff * w // h))
            groups[cutoff] = acc
        for r, z in groups.items():
            y = _polyphase_conv3x3_up(z, head_w, h // r)
            out = y if out is None else out + y

    for r in sorted(hi):
        for f, off, use in hi[r]:
            # (3, 3, use, C_out): the projection folded into the conv
            wc = torch.einsum("cd,tsdo->tsco", weight[off : off + use], head_w)
            y = _polyphase_conv3x3_up(f[..., :use], wc, h // r)
            out = y if out is None else out + y

    return out + head_b.to(out.dtype)


def _conv3x3(x, w):
    """conv3x3(x, w) with padding 1 (``F.conv2d``'s function), NHWC / HWIO:
    y = x @ W over the 9 taps at once, then out(i, j) = sum over the taps
    (t, s) of y(i + t - 1, j + s - 1, t, s), as 9 shifted adds. ``w`` is
    cast to x's type (the folds compose their weights in float32 and the
    JAX convs take them in the features' type)."""
    b, h, wd, c_in = x.shape
    c_out = w.shape[-1]
    taps = w.permute(2, 0, 1, 3).reshape(c_in, 9 * c_out).to(x.dtype)
    y = (x.reshape(-1, c_in) @ taps).reshape(b, h, wd, 3, 3, c_out)
    out = y[:, :, :, 1, 1].clone()
    for t in range(3):
        for s in range(3):
            di, dj = t - 1, s - 1
            if di == dj == 0:
                continue
            out[:, max(0, -di) : h - max(0, di), max(0, -dj) : wd - max(0, dj)] += \
                y[:, max(0, di) : h + min(0, di), max(0, dj) : wd + min(0, dj), t, s]
    return out


def _polyphase_conv3x3_up(z, head_w, f):
    """conv3x3(nearest_up_f(z), head_w) without the upsampled tensor.

    Fine output (f*i + d, ...) reads fine taps f*i + d + t - 1 (t in 0..2),
    which lie in the coarse window (i-1, i, i+1): phase 0 reaches i-1 by tap
    0, phase f-1 reaches i+1 by tap 2, every other (phase, tap) lands on i.
    The f^2 phases stack into one conv with f^2 * C_out outputs, then a
    depth-to-space reshape. f = 1 is the plain conv.
    """
    if f == 1:
        return _conv3x3(z, head_w)
    b_, r, rw, c_in = z.shape
    c_out = head_w.shape[-1]
    # E[d, pos, tap]: phase d's fine tap lands on coarse window position pos
    E = torch.zeros((f, 3, 3), dtype=head_w.dtype, device=head_w.device)
    E[:, 1, :] = 1.0
    E[0, 1, 0] = 0.0
    E[0, 0, 0] = 1.0  # phase 0, tap 0 -> i-1
    E[f - 1, 1, 2] = 0.0
    E[f - 1, 2, 2] = 1.0  # phase f-1, tap 2 -> i+1
    wp = torch.einsum("yvt,xws,tsdo->vwdyxo", E, E, head_w)
    wp = wp.reshape(3, 3, c_in, f * f * c_out)
    yc = _conv3x3(z, wp)
    yc = yc.reshape(b_, r, rw, f, f, c_out)
    return yc.permute(0, 1, 3, 2, 4, 5).reshape(b_, f * r, f * rw, c_out)


def project_segment_fcn(features, weight, seg_params, size, hlen=None):
    """Logits of an FCN head over the level-decomposed embedding: the first
    conv (dilation 1) folded into the pyramid by
    ``project_segment_single_conv``, the rest as
    ``one_shot_segmentor_apply`` runs them."""
    from ganecdotes_torch.selfsup.heads import DILATIONS

    out = project_segment_single_conv(
        features, weight, seg_params[0]["weight"], seg_params[0]["bias"],
        hlen=hlen)
    for p, d in zip(seg_params[1:], DILATIONS[size][1:]):
        out = leaky_relu(out)
        out = conv2d_dilated_nhwc(out, p["weight"], dilation=d, padding=d)
        out = out + p["bias"].to(out.dtype)
    return out


def narrow_first_conv(total_in, c_out):
    """Whether the first conv should run on the materialised nearest-up
    concat (a concat no wider than 2 * C_out moves fewer bytes than the
    polyphase form's f^2 * C_out phase outputs) rather than level by level.
    Shared by ``concat_segment_fcn`` and ``kmeans.hfc_segment_fcn``."""
    return total_in <= 2 * c_out


def concat_segment_fcn(features, seg_params, size, hlen=None, n_layers=None,
                       out_hw=None):
    """Logits of the head over the raw upsample + concat features, its first
    conv folded into the level pyramid (RepurposeGAN's serving form, and
    ``kmeans.hfc_segment_fcn``'s wide branch), so the (B, H, W, sum c)
    concat never exists:

        conv3x3(concat_l up_f(f_l), W) = sum_l conv3x3(up_f(f_l), W[:, :, s_l])

    with ``s_l`` level l's input-channel slice. Full-resolution levels run
    ``_conv3x3``; levels above the cutoff min(h // 4, 64) run their own
    polyphase conv; levels at or below it are lifted to the cutoff
    resolution, concatenated there and share one polyphase conv. A concat
    no wider than 2 * C_out (``narrow_first_conv``) is materialised and
    convolved directly. The other convs run as ``one_shot_segmentor_apply``
    runs them. ``out_hw`` is the output resolution (default the finest
    map's). A ``Lin`` head is a per-pixel Linear, so it folds into
    ``project_feature_maps``.
    """
    from ganecdotes_torch.selfsup.heads import DILATIONS

    if n_layers is not None:
        features = features[:n_layers]
    if out_hw is not None:
        h, w = out_hw
    else:
        h = max(f.shape[1] for f in features)
        w = max(f.shape[2] for f in features)
    w0, b0 = seg_params[0]["weight"], seg_params[0]["bias"]
    if size == "Lin":
        z = resize_nearest(project_feature_maps(features, w0, hlen=hlen), (h, w))
        return leaky_relu(z + b0.to(z.dtype))

    total = hlen if hlen is not None else w0.shape[2]
    chunks = _level_chunks(layer_channel_dims(features), total)
    levels = [(f[..., :use], w0[:, :, off : off + use])
              for f, (off, use) in zip(features, chunks) if use > 0]
    if narrow_first_conv(total, w0.shape[3]):
        out = conv2d_dilated_nhwc(
            torch.cat([resize_nearest(f, (h, w)) for f, _ in levels], dim=-1),
            torch.cat([wl for _, wl in levels], dim=2), dilation=1, padding=1)
    else:
        cutoff = min(h // 4, 64)
        out = None
        lift, lift_w = [], []  # the levels merged at the cutoff resolution
        for f, wl in levels:
            r = f.shape[1]
            if r == h and f.shape[2] == w:
                y = _conv3x3(f, wl)
            elif r > cutoff:
                y = _polyphase_conv3x3_up(f, wl, h // r)
            else:
                lift.append(resize_nearest(f, (cutoff, cutoff * w // h)))
                lift_w.append(wl)
                continue
            out = y if out is None else out + y
        if lift:
            y = _polyphase_conv3x3_up(torch.cat(lift, dim=-1),
                                      torch.cat(lift_w, dim=2), h // cutoff)
            out = y if out is None else out + y
    out = out + b0.to(out.dtype)
    for p, d in zip(seg_params[1:], DILATIONS[size][1:]):
        out = leaky_relu(out)
        out = conv2d_dilated_nhwc(out, p["weight"], dilation=d, padding=d)
        out = out + p["bias"].to(out.dtype)
    return out
