"""Adaptive discriminator augmentation (StyleGAN2-ADA), NHWC (port of
ganecdotes_tpu/gan/ada.py).

Random geometry (flip, 90-degree rotations, translations, isotropic and
anisotropic scale, rotations) composed as 3x3 matrices and applied with
SYM6 wavelet anti-aliasing (2x upsample, the affine warp, 2x downsample),
then random color (brightness, contrast, luma flip, hue, saturation) as 4x4
matrices; and the adaptive-p controller.

The warp runs through ``ops.resample_rows`` ('shear_pallas', the default on
every device: the CUDA pass with ``KERNELS``, its plain version with
``PLAIN``), and the four 12-tap wavelet passes (2x up on each axis before
it, 2x down after) through ``ops.upfirdn2d``: the FIR kernel with
``KERNELS``, ``upfirdn2d_ref`` with ``PLAIN`` (the JAX package runs them
through its ``upfirdn2d``, as C = 3 matmuls). Random
matrices are drawn from an explicit ``torch.Generator`` on the CPU; the
trainer draws them up front (``gan/train.py::draw_step_inputs``, as
``TransformDraws``), composes them at the iteration's p on the device
(``compose_transforms``) and passes them in as ``transform_matrix=(G, C)``.

On a bfloat16 image the augmentation runs in bf16, as the JAX package's
under ``compute_dtype='bfloat16'``: the wavelet passes and the warp on the
kernels' bf16 instances (the warp's geometry float32), the color matrices
cast to the image's type for the einsum (JAX ada.py:306-307).
"""

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ganecdotes_torch.ops.affine_warp import affine_warp, norm_to_pixel_matrix
from ganecdotes_torch.ops.grid_sample import grid_sample_bilinear
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.parallel.mesh import all_reduce_sum

SYM6 = (
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
)

# ---------------------------------------------------------------------------
# transform matrices (batched, float32)
# ---------------------------------------------------------------------------


def _eye(n, b):
    return torch.eye(n).repeat(b, 1, 1)


def translate_mat(t_x, t_y):
    mat = _eye(3, t_x.shape[0])
    mat[:, 0, 2], mat[:, 1, 2] = t_x, t_y
    return mat


def rotate_mat(theta):
    mat = _eye(3, theta.shape[0])
    c, s = torch.cos(theta), torch.sin(theta)
    mat[:, 0, 0], mat[:, 0, 1], mat[:, 1, 0], mat[:, 1, 1] = c, -s, s, c
    return mat


def scale_mat(s_x, s_y):
    mat = _eye(3, s_x.shape[0])
    mat[:, 0, 0], mat[:, 1, 1] = s_x, s_y
    return mat


def translate3d_mat(t_x, t_y, t_z):
    mat = _eye(4, t_x.shape[0])
    mat[:, 0, 3], mat[:, 1, 3], mat[:, 2, 3] = t_x, t_y, t_z
    return mat


def scale3d_mat(s_x, s_y, s_z):
    mat = _eye(4, s_x.shape[0])
    mat[:, 0, 0], mat[:, 1, 1], mat[:, 2, 2] = s_x, s_y, s_z
    return mat


def rotate3d_mat(axis, theta):
    u_x, u_y, u_z = axis
    cross = torch.tensor([(0, -u_z, u_y), (u_z, 0, -u_x), (-u_y, u_x, 0)])
    ax = torch.tensor(axis)
    outer = torch.outer(ax, ax)
    sin_t = torch.sin(theta)[:, None, None]
    cos_t = torch.cos(theta)[:, None, None]
    rot = cos_t * torch.eye(3) + sin_t * cross + (1 - cos_t) * outer
    mat = _eye(4, theta.shape[0])
    mat[:, :3, :3] = rot
    return mat


def luma_flip_mat(axis, i):
    ax = torch.tensor(axis + (0,))
    return _eye(4, i.shape[0]) - 2 * torch.outer(ax, ax) * i[:, None, None]


def saturation_mat(axis, i):
    ax = torch.tensor(axis + (0,))
    outer = torch.outer(ax, ax)
    return outer + (_eye(4, i.shape[0]) - outer) * i[:, None, None]


# ---------------------------------------------------------------------------
# random sampling of composed transforms
# ---------------------------------------------------------------------------


class TransformDraws(NamedTuple):
    """The random numbers of one ``sample_transforms`` call, drawn on the
    CPU in its order: per random transform (geometric, then color) the
    candidate matrices (B, n, n), the uniforms (B, 1, 1) that select them
    against the probability, and which probability ("p" or "p_rot", the
    rotations' 1 - sqrt(1 - p)). ``compose_transforms`` turns them into
    (G, C) at a probability known later (a device tensor: no host sync)."""

    affine: List[Tuple[torch.Tensor, torch.Tensor, str]]
    color: List[Tuple[torch.Tensor, torch.Tensor, str]]


def _compose(steps, p, n, device=None):
    """prod over the steps, last first, of select * T + (1 - select) * I,
    select = u < (p or p_rot). ``p`` a float, or a 0-d tensor on ``device``
    (the matrices move there)."""
    if isinstance(p, torch.Tensor):
        probs = {"p": p, "p_rot": 1 - torch.sqrt(1 - p)}
    else:
        probs = {"p": p, "p_rot": 1 - math.sqrt(1 - p)}
    b = steps[0][0].shape[0]
    eye = _eye(n, b).to(device)
    mat = eye
    for transform, u, kind in steps:
        transform, u = transform.to(device), u.to(device)
        select = (u < probs[kind]).to(transform.dtype)
        mat = (select * transform + (1 - select) * eye) @ mat
    return mat


def draw_affine(generator, size, height, width):
    """The geometric transforms' draws (ref ada.py:269-325): the candidate
    matrices and selection uniforms of ``sample_affine``, in its order."""
    g = generator
    steps = []

    def step(transform, kind="p"):
        steps.append((transform, torch.rand(size, 1, 1, generator=g), kind))

    # flip
    param = torch.randint(0, 2, (size,), generator=g).to(torch.float32)
    step(scale_mat(1 - 2.0 * param, torch.ones(size)))
    # 90-degree rotate (0 or 3 quarter-turns)
    param = torch.tensor([0.0, 3.0])[torch.randint(0, 2, (size,), generator=g)]
    step(rotate_mat(-math.pi / 2 * param))
    # integer translate
    param = torch.rand(2, size, generator=g) * 0.25 - 0.125
    step(translate_mat(torch.round(param[1] * width), torch.round(param[0] * height)))
    # isotropic scale
    param = torch.exp(torch.randn(size, generator=g) * 0.2 * math.log(2))
    step(scale_mat(param, param))
    # pre-rotate
    param = (torch.rand(size, generator=g) * 2 - 1) * math.pi
    step(rotate_mat(-param), "p_rot")
    # anisotropic scale
    param = torch.exp(torch.randn(size, generator=g) * 0.2 * math.log(2))
    step(scale_mat(param, 1 / param))
    # post-rotate
    param = (torch.rand(size, generator=g) * 2 - 1) * math.pi
    step(rotate_mat(-param), "p_rot")
    # fractional translate
    param = torch.randn(2, size, generator=g) * 0.125
    step(translate_mat(param[1] * width, param[0] * height))
    return steps


def draw_color(generator, size):
    """The color transforms' draws (ref ada.py:328-359), in
    ``sample_color``'s order."""
    g = generator
    steps = []
    axis_val = 1 / math.sqrt(3)
    axis = (axis_val, axis_val, axis_val)

    def step(transform):
        steps.append((transform, torch.rand(size, 1, 1, generator=g), "p"))

    # brightness
    param = torch.randn(size, generator=g) * 0.2
    step(translate3d_mat(param, param, param))
    # contrast
    param = torch.exp(torch.randn(size, generator=g) * 0.5 * math.log(2))
    step(scale3d_mat(param, param, param))
    # luma flip
    param = torch.randint(0, 2, (size,), generator=g).to(torch.float32)
    step(luma_flip_mat(axis, param))
    # hue rotation
    param = (torch.rand(size, generator=g) * 2 - 1) * math.pi
    step(rotate3d_mat(axis, param))
    # saturation
    param = torch.exp(torch.randn(size, generator=g) * math.log(2))
    step(saturation_mat(axis, param))
    return steps


def sample_affine(generator, p, size, height, width):
    """Composed geometric transform (ref ada.py:269-325), (B, 3, 3), drawn on
    the CPU from ``generator``; ``p`` a float."""
    return _compose(draw_affine(generator, size, height, width), p, 3)


def sample_color(generator, p, size):
    """Composed color transform (ref ada.py:328-359), (B, 4, 4), drawn on the
    CPU from ``generator``; ``p`` a float."""
    return _compose(draw_color(generator, size), p, 4)


def draw_transforms(generator, size, height, width):
    """The draws of one ``sample_transforms`` call (``TransformDraws``)."""
    return TransformDraws(draw_affine(generator, size, height, width),
                          draw_color(generator, size))


def compose_transforms(draws, p, device=None):
    """(G, C) of ``TransformDraws`` at probability ``p``: a float (composed
    on the CPU, moved to ``device``) or a 0-d tensor (composed on its
    device, with no host sync; the inverse without its error check)."""
    if isinstance(p, torch.Tensor):
        G = torch.linalg.inv_ex(_compose(draws.affine, p, 3, p.device))[0]
        return G, _compose(draws.color, p, 4, p.device)
    G = torch.linalg.inv(_compose(draws.affine, p, 3))
    return G.to(device), _compose(draws.color, p, 4).to(device)


def sample_transforms(generator, p, size, height, width, device=None):
    """(G, C) for one ``augment`` call: the inverse of a ``sample_affine``
    draw and a ``sample_color`` draw, in that order, on ``device``."""
    return compose_transforms(draw_transforms(generator, size, height, width), p,
                              device)


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def _affine_grid(theta, h, w):
    """F.affine_grid(align_corners=False) semantics: normalized coords."""
    dev = theta.device
    xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                        torch.ones(h, w, device=dev)], dim=-1)
    return torch.einsum("bij,hwj->bhwi", theta, base.to(theta.dtype))


def _scale_single(s_x, s_y, device):
    return torch.tensor([[s_x, 0, 0], [0, s_y, 0], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def _translate_single(t_x, t_y, device):
    return torch.tensor([[1, 0, t_x], [0, 1, t_y], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def warp_geometry(G, h, w, len_k=len(SYM6), pad_frac=0.25):
    """Where ADA's warp samples for (B, 3, 3) inverse affine matrices ``G``
    on an h x w image: (G_inv, the padded 2x source's (H, W), the warp's
    output (H, W)), with ``G_inv`` in ``F.affine_grid`` coordinates."""
    dev = G.device
    pad_k = len_k // 4
    pad_x = int(round(w * pad_frac)) + pad_k * 2
    pad_y = int(round(h * pad_frac)) + pad_k * 2
    src_h, src_w = 2 * (h + 2 * pad_y), 2 * (w + 2 * pad_x)
    G_inv = _scale_single(2, 2, dev) @ G @ _scale_single(0.5, 0.5, dev)
    G_inv = (_translate_single(-0.5, -0.5, dev) @ G_inv
             @ _translate_single(0.5, 0.5, dev))
    out_h = (h + pad_k * 2) * 2
    out_w = (w + pad_k * 2) * 2
    G_inv = (_scale_single(2 / src_w, 2 / src_h, dev)
             @ G_inv
             @ _scale_single(1 / (2 / out_w), 1 / (2 / out_h), dev))
    return G_inv, (src_h, src_w), (out_h, out_w)


def reflect_pad(img, pad_y, pad_x):
    """``F.pad(..., mode="reflect")`` of the NHWC ``img`` by ``pad_y`` rows
    and ``pad_x`` columns on each side, built from slices and flips joined
    by ``torch.cat``, one axis at a time. The forward is bit-equal to
    ``F.pad``'s; the backward is slices, flips and adds in a fixed order,
    where ``F.pad``'s CUDA backward sums with atomics, so training repeats
    bit for bit. As ``F.pad``, it takes a pad smaller than the axis."""
    for axis, p in ((1, pad_y), (2, pad_x)):
        n = img.shape[axis]
        if not 0 <= p < n:
            raise ValueError(f"reflect pad of {p} on an axis of {n}: the pad "
                             "must be non-negative and smaller than the axis")
        if p:
            img = torch.cat([img.narrow(axis, 1, p).flip(axis), img,
                             img.narrow(axis, n - 1 - p, p).flip(axis)], dim=axis)
    return img


def wavelet_passes(k):
    """ADA's four separable anti-aliasing passes for the 1-D float32 taps
    ``k``, as (2-D kernel, up, down, pad) in ``upfirdn2d``'s terms, as
    ganecdotes_tpu/gan/ada.py::random_apply_affine runs them: the 2x
    upsample along x then y of the padded image, and the 2x downsample
    along x then y of the warp's output with the flipped taps."""
    len_k = len(k)
    up_pad = ((len_k + 1) // 2, (len_k - 2) // 2)
    k_flip = np.ascontiguousarray(k[::-1])
    d_p = -(len_k // 4) * 2
    down_pad = (d_p + (len_k - 1) // 2, d_p + (len_k - 2) // 2)
    return [(k[None, :], (2, 1), 1, (up_pad[0], up_pad[1], 0, 0)),
            (k[:, None], (1, 2), 1, (0, 0, up_pad[0], up_pad[1])),
            (k_flip[None, :], 1, (2, 1), (down_pad[0], down_pad[1], 0, 0)),
            (k_flip[:, None], 1, (1, 2), (0, 0, down_pad[0], down_pad[1]))]


def random_apply_affine(img, p=None, generator=None, G=None,
                        antialiasing_kernel=SYM6, pad_frac=0.25,
                        warp_impl="shear_pallas", ops=KERNELS):
    """Geometric ADA transform with SYM6 anti-aliasing (ref ada.py:464-517).

    img: (B, H, W, C) NHWC. ``G`` the (B, 3, 3) inverse affine matrices, or
    None to draw them from ``generator`` at probability ``p``. A static
    reflect pad of ``pad_frac`` of the size plus the kernel's margin
    replaces the reference's per-batch pad. ``warp_impl``: 'shear_pallas'
    (``ops.resample_rows``), 'shear' (the plain passes) or 'exact' (the
    grid_sample oracle). ``ops`` also runs the four wavelet passes
    (``ops.upfirdn2d``). Returns (img_out, G).
    """
    k = np.asarray(antialiasing_kernel, dtype=np.float32)
    len_k = len(k)
    b, h, w, c = img.shape
    if G is None:
        G = torch.linalg.inv(sample_affine(generator, p, b, h, w)).to(img.device)

    pad_k = len_k // 4
    pad_x = int(round(w * pad_frac)) + pad_k * 2
    pad_y = int(round(h * pad_frac)) + pad_k * 2
    img_pad = reflect_pad(img, pad_y, pad_x)

    passes = wavelet_passes(k)
    img_2x = img_pad
    for kern, up, down, pad in passes[:2]:
        img_2x = ops.upfirdn2d(img_2x, kern, up=up, down=down, pad=pad)

    G_inv, src_hw, (out_h, out_w) = warp_geometry(G, h, w, len_k, pad_frac)
    if warp_impl == "exact":
        grid = _affine_grid(G_inv[:, :2, :], out_h, out_w)
        img_affine = grid_sample_bilinear(img_2x, grid)
    else:
        M_pix = norm_to_pixel_matrix(G_inv, img_2x.shape[1:3], (out_h, out_w))
        img_affine = affine_warp(img_2x, M_pix, out_hw=(out_h, out_w),
                                 impl=warp_impl, ops=ops)

    img_down = img_affine
    for kern, up, down, pad in passes[2:]:
        img_down = ops.upfirdn2d(img_down, kern, up=up, down=down, pad=pad)
    return img_down, G


def apply_color(img, mat):
    """img (B, H, W, 3) @ mat[:3, :3]^T + mat[:3, 3] (ref ada.py:520-528)."""
    out = torch.einsum("bhwc,bdc->bhwd", img, mat[:, :3, :3].to(img.dtype))
    return out + mat[:, :3, 3][:, None, None, :].to(img.dtype)


def random_apply_color(img, p=None, generator=None, C=None):
    if C is None:
        C = sample_color(generator, p, img.shape[0]).to(img.device)
    return apply_color(img, C), C


def augment(img, p=None, generator=None, transform_matrix=(None, None),
            warp_impl="shear_pallas", ops=KERNELS):
    """Full ADA augmentation: affine then color (ref ada.py:540-544).
    Returns (img, (G, C))."""
    img, G = random_apply_affine(img, p, generator, transform_matrix[0],
                                 warp_impl=warp_impl, ops=ops)
    img, C = random_apply_color(img, p, generator, transform_matrix[1])
    return img, (G, C)


# ---------------------------------------------------------------------------
# adaptive-p controller
# ---------------------------------------------------------------------------


def ada_init_state(p0=0.0, device=None):
    return {
        "buf": torch.zeros(2, device=device),
        "update": torch.zeros((), dtype=torch.int32, device=device),
        "p": torch.tensor(float(p0), dtype=torch.float32, device=device),
        "r_t": torch.tensor(0.0, dtype=torch.float32, device=device),
    }


def ada_update(state, real_pred, target, aug_len, update_every, mesh=None):
    """One controller step on device tensors, with no host sync: adds the
    sign statistics of ``real_pred`` to the buffer and, every
    ``update_every``-th call, moves p by sign(r_t - target) * n / aug_len.
    Under a data-parallel ``mesh`` the statistics are summed over the ranks
    (JAX's ``axis_name`` psum, the reference's all_reduce)."""
    real_pred = real_pred.detach()
    stats = torch.stack([torch.sign(real_pred).sum(),
                         torch.tensor(float(real_pred.numel()), device=real_pred.device)])
    stats = all_reduce_sum(mesh, stats)
    buf = state["buf"] + stats
    update = state["update"] + 1
    due = update % update_every == 0
    r_t = buf[0] / buf[1]
    sign = torch.where(r_t > target, 1.0, -1.0)
    p_new = torch.clamp(state["p"] + sign * buf[1] / aug_len, 0.0, 1.0)
    return {
        "buf": torch.where(due, torch.zeros_like(buf), buf),
        "update": torch.where(due, torch.zeros_like(update), update),
        "p": torch.where(due, p_new, state["p"]),
        "r_t": torch.where(due, r_t, state["r_t"]),
    }


class AdaptiveAugment:
    """Stateful wrapper with the reference's class API (ada.py:28-91), the
    intended statistic E[sign(D(real))] against the target."""

    def __init__(self, ada_aug_target, ada_aug_len, update_every, device=None):
        self.ada_aug_target = ada_aug_target
        self.ada_aug_len = ada_aug_len
        self.update_every = update_every
        self.state = ada_init_state(device=device)

    @property
    def r_t_stat(self):
        return float(self.state["r_t"])

    @property
    def ada_aug_p(self):
        return float(self.state["p"])

    def tune(self, real_pred):
        self.state = ada_update(self.state, torch.as_tensor(real_pred),
                                self.ada_aug_target, self.ada_aug_len,
                                self.update_every)
        return float(self.state["p"])
