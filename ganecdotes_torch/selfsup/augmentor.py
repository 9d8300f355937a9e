"""Latent-perturbation views, feature grouping by block and feature-space
rotate/flip for SwAV, SimCLR and k-means (port of
ganecdotes_tpu/selfsup/augmentor.py:23-151).

A view lerps the w+ rows of one generator block toward a fresh
``style(randn)`` sample, ``(1 - sigma) * w + sigma * w_rand``, and
re-synthesises. The random numbers are passed in: ``perturb_latents`` takes
the (B * n_latent, D) normals the JAX version draws from its key, and the
rotation takes its angle and flip.
"""

import math

import torch

from ganecdotes_torch.models.stylegan2.generator import (
    generator_forward,
    mapping_apply,
)
from ganecdotes_torch.ops.opset import KERNELS


def perturb_latents(gen, w_plus, z_rand, row_std, ops=KERNELS):
    """Lerp each w+ row toward style(z_rand) with per-row strength.

    w_plus: (B, n_latent, D); z_rand: (B * n_latent, D) normals; row_std:
    (n_latent,), zero entries leave their row untouched.
    """
    b, n_latent, d = w_plus.shape
    w_rand = mapping_apply(gen, z_rand.reshape(b * n_latent, d), ops)
    w_rand = w_rand.reshape(b, n_latent, d)
    sigma = row_std.reshape(1, n_latent, 1).to(w_plus.dtype)
    return (1.0 - sigma) * w_plus + sigma * w_rand


def block_row_std(layer_no, n_layers, perturb_std, n_latent, device=None):
    """sigma vector perturbing rows (2l, 2l+1) of block ``layer_no``; rows at
    or beyond 2 * n_layers stay untouched."""
    perturb_std = torch.as_tensor(perturb_std, dtype=torch.float32,
                                  device=device)
    rows = torch.arange(n_latent, device=device)
    layer_no = int(layer_no)
    sel = (rows // 2 == layer_no) & (rows < 2 * n_layers)
    std_val = perturb_std[min(max(layer_no, 0), len(perturb_std) - 1)]
    return torch.where(sel, std_val, torch.zeros((), device=device))


def perturbed_features(gen, w_plus, z_rand, layer_no, n_layers, perturb_std,
                       truncation, mean_latent_w, ops=KERNELS):
    """One augmented view: perturb block ``layer_no``, re-synthesise with the
    fixed noise buffers. Returns (image, features).

    As in the JAX package, ``generator_forward`` applies ``truncation`` to the
    perturbed w+ again, though the caller's w+ is already truncated.
    """
    row_std = block_row_std(layer_no, n_layers, perturb_std,
                            gen.meta["n_latent"], device=w_plus.device)
    w_new = perturb_latents(gen, w_plus, z_rand, row_std, ops)
    return generator_forward(gen, [w_new], input_is_latent=True,
                             truncation=truncation,
                             truncation_latent=mean_latent_w, ops=ops)


def group_features_by_block(features, skip_const=False, concat=True):
    """Per-block feature groups: [f0, cat(f1, f2), cat(f3, f4), ...], the
    pairs concatenated along channels (``skip_const`` drops f0). With
    ``concat=False`` each pair stays a tuple of its two parts, for consumers
    that distribute over the channel split (``kmeans.kmeans_predict_parts``)."""
    n_blocks = len(features) // 2
    pairs = [(features[2 * n + 1], features[2 * n + 2]) for n in range(n_blocks)]
    if concat:
        pairs = [torch.cat(p, dim=-1) for p in pairs]
    return pairs if skip_const else [features[0]] + pairs


# ---------------------------------------------------------------------------
# feature-space RandomRotation(10) + RandomHorizontalFlip
# ---------------------------------------------------------------------------


def rotate_flip_nhwc(x, angle_rad, flip):
    """Nearest-neighbour rotation about the image centre, then an optional
    horizontal flip; pixels sampled from outside the image are zero.

    Rounds half to even (``torch.round``), as ``jnp.round`` does.
    """
    _, h, w, _ = x.shape
    dev = x.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    angle = torch.as_tensor(angle_rad, dtype=torch.float32, device=dev)
    cos, sin = torch.cos(angle), torch.sin(angle)
    # inverse mapping: output (y, x) samples input (y', x')
    src_y = yy * cos - xx * sin + cy
    src_x = yy * sin + xx * cos + cx
    iy = torch.round(src_y).to(torch.long)
    ix = torch.round(src_x).to(torch.long)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = x[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1), :]
    out = out * valid[None, :, :, None].to(x.dtype)
    return out.flip(2) if bool(flip) else out


def random_rotate_flip_params(generator, max_deg=10.0, flip_p=0.5):
    """(angle in radians ~ U[-max_deg, max_deg) degrees, flip ~ Bernoulli)."""
    u = torch.rand((), generator=generator).item()
    angle = (-max_deg + 2 * max_deg * u) * (math.pi / 180.0)
    flip = torch.rand((), generator=generator).item() < flip_p
    return angle, flip


def rotate_flip_features(features, angle_rad, flip):
    """Apply the shared (angle, flip) to every pyramid level."""
    return [rotate_flip_nhwc(f, angle_rad, flip) for f in features]
