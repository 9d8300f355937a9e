"""ADA's random transforms for one augmentation of a batch, drawn on the
device from a ``torch.Generator``: StyleGAN2-ADA's 'bgc' pipeline
(Karras et al. 2020, arXiv:2006.06676). Each transform is drawn for every
image and applied with probability ``p`` (the two free rotations with
1 - sqrt(1 - p)):

- geometric: x-flip, 90-degree rotation (0 or 3 quarter turns), integer
  translation (up to 1/8 of the side), isotropic scale (log2-normal, std
  0.2), pre-rotation (uniform angle), anisotropic scale (std 0.2),
  post-rotation, fractional translation (normal, std 1/8 of the side);
- color: brightness (normal, std 0.2), contrast (log2-normal, std 0.5),
  luma flip, hue rotation (uniform angle about the grey axis), saturation
  (log2-normal, std 1).

Returns (G, C): the inverse of the composed (B, 3, 3) geometric matrix and
the composed (B, 4, 4) color matrix, as the program's ``augment`` takes
them.
"""

import math

import torch


def _eye(n, b, dev):
    return torch.eye(n, device=dev).repeat(b, 1, 1)


def _translate(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _rotate(theta):
    m = _eye(3, theta.shape[0], theta.device)
    c, s = torch.cos(theta), torch.sin(theta)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _scale(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _color_translate(t):
    m = _eye(4, t.shape[0], t.device)
    m[:, 0, 3] = m[:, 1, 3] = m[:, 2, 3] = t
    return m


def _color_scale(s):
    m = _eye(4, s.shape[0], s.device)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = s
    return m


def _grey(dev):
    v = 1 / math.sqrt(3)
    return torch.tensor([v, v, v, 0.0], device=dev)


def _luma_flip(i):
    ax = _grey(i.device)
    return _eye(4, i.shape[0], i.device) - 2 * torch.outer(ax, ax) * i[:, None, None]


def _hue(theta):
    u = _grey(theta.device)[:3]
    cross = torch.tensor([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]],
                         device=theta.device)
    s, c = torch.sin(theta)[:, None, None], torch.cos(theta)[:, None, None]
    rot = c * torch.eye(3, device=theta.device) + s * cross + (1 - c) * torch.outer(u, u)
    m = _eye(4, theta.shape[0], theta.device)
    m[:, :3, :3] = rot
    return m


def _saturation(i):
    ax = _grey(i.device)
    outer = torch.outer(ax, ax)
    return outer + (_eye(4, i.shape[0], i.device) - outer) * i[:, None, None]


def draw(gen, p, b, h, w, device):
    """(G, C) of one augmentation of ``b`` images of h x w at probability
    ``p``, from the device generator ``gen``."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def n(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    p_rot = 1 - math.sqrt(1 - p)
    ln2 = math.log(2)
    geo = [
        (_scale(1 - 2.0 * (u(b) < 0.5).float(), torch.ones(b, device=device)), p),
        (_rotate(-math.pi / 2 * 3 * (u(b) < 0.5).float()), p),
        (_translate(torch.round((u(b) * 0.25 - 0.125) * w),
                    torch.round((u(b) * 0.25 - 0.125) * h)), p),
    ]
    s = torch.exp(n(b) * 0.2 * ln2)
    geo.append((_scale(s, s), p))
    geo.append((_rotate(-(u(b) * 2 - 1) * math.pi), p_rot))
    s = torch.exp(n(b) * 0.2 * ln2)
    geo.append((_scale(s, 1 / s), p))
    geo.append((_rotate(-(u(b) * 2 - 1) * math.pi), p_rot))
    geo.append((_translate(n(b) * 0.125 * w, n(b) * 0.125 * h), p))
    col = [
        (_color_translate(n(b) * 0.2), p),
        (_color_scale(torch.exp(n(b) * 0.5 * ln2)), p),
        (_luma_flip((u(b) < 0.5).float()), p),
        (_hue((u(b) * 2 - 1) * math.pi), p),
        (_saturation(torch.exp(n(b) * ln2)), p),
    ]

    def compose(steps, size):
        mat = _eye(size, b, device)
        for t, prob in steps:
            keep = (u(b, 1, 1) < prob).float()
            mat = (keep * t + (1 - keep) * _eye(size, b, device)) @ mat
        return mat

    return torch.linalg.inv(compose(geo, 3)), compose(col, 4)
