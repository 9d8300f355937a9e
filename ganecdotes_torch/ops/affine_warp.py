"""Batched affine image warping for ADA, NHWC (port of
ganecdotes_tpu/ops/affine_warp.py).

The warp is a two-pass separable resample (see the JAX module's docstring
for the algebra): with the pixel-space map ``src = M @ (j, i, 1)``,
``M = [[a, b, tx], [c, d, ty]]``,

* pass V: ``A[y, x'] = X[delta*y + eps*x' + zeta, x']``
* pass H: ``out[y, j] = A[y, a*j + b*y + tx]``

with ``eps = c/a``, ``delta = d - eps*b``, ``zeta = ty - eps*tx``, each a
1-D bilinear resample along one axis. Images whose ``|c| > |a|`` are warped
transposed, so ``|eps| <= 1``.

``_resample_pass`` is the plain version of one pass, in the JAX package's
own form (a per-line bit-decomposed roll, then three one-hot selections,
a validity mask and a lerp), differentiable by autograd to any order; it is
the plain version the CUDA pass (ops/resample.py, csrc/affine_warp.cu) is
held against. ``_resample_pass_t`` is its exact adjoint along rows.
``affine_warp_exact`` is the per-pixel bilinear gather (the grid_sample
oracle).
"""

import math

import torch

from ganecdotes_torch.ops.grid_sample import grid_sample_bilinear


def norm_to_pixel_matrix(G_inv, in_hw, out_hw):
    """(B, 3, 3) normalized-coordinate warp (``F.affine_grid``,
    align_corners=False) -> (B, 2, 3) pixel-space map
    ``(sx, sy) = M @ (j, i, 1)``; ``in_hw``/``out_hw`` the source and output
    (H, W)."""
    h_in, w_in = in_hw
    h_out, w_out = out_hw
    dev = G_inv.device
    A_out = torch.tensor([[2.0 / w_out, 0.0, 1.0 / w_out - 1.0],
                          [0.0, 2.0 / h_out, 1.0 / h_out - 1.0],
                          [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    A_in = torch.tensor([[w_in / 2.0, 0.0, (w_in - 1.0) / 2.0],
                         [0.0, h_in / 2.0, (h_in - 1.0) / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    M = A_in @ G_inv.to(torch.float32) @ A_out
    return M[:, :2, :]


def affine_warp_exact(x, M, out_hw=None):
    """Reference semantics: per-pixel bilinear gather."""
    b, h, w, _ = x.shape
    out_h, out_w = out_hw or (h, w)
    jj = torch.arange(out_w, dtype=torch.float32, device=x.device)
    ii = torch.arange(out_h, dtype=torch.float32, device=x.device)
    base = torch.stack([jj[None, :].expand(out_h, out_w),
                        ii[:, None].expand(out_h, out_w),
                        torch.ones(out_h, out_w, device=x.device)], dim=-1)
    src = torch.einsum("bij,hwj->bhwi", M.to(torch.float32), base)
    # pixel -> grid_sample's normalized coords: gx = (2*sx + 1)/W - 1
    gx = (2.0 * src[..., 0] + 1.0) / w - 1.0
    gy = (2.0 * src[..., 1] + 1.0) / h - 1.0
    return grid_sample_bilinear(x, torch.stack([gx, gy], dim=-1))


def _per_line_roll(x, amounts, axis):
    """x[..., (u + amounts) mod L, ...] along ``axis`` of (B, C, H, W) ``x``;
    ``amounts`` (B, L_other) int in [0, L), constant along ``axis``.
    Decomposed into conditional static rolls of each bit."""
    length = x.shape[axis]
    n_bits = max(1, math.ceil(math.log2(length)))
    out = x
    for k in range(n_bits):
        bit = (amounts >> k) & 1
        cond = (bit == 1)[:, None].unsqueeze(axis)  # unit dim at the rolled axis
        out = torch.where(cond, torch.roll(out, -(1 << k), dims=axis), out)
    return out


def _pass_geometry(alpha, intercept, out_len):
    """U = floor(intercept) (B, L_other) and its fraction, q = floor(alpha*u)
    (B, out_len) and its fraction, all float32."""
    alpha = alpha.to(torch.float32)
    intercept = intercept.to(torch.float32)
    U = torch.floor(intercept)
    v = intercept - U
    u_idx = torch.arange(out_len, dtype=torch.float32, device=intercept.device)
    au = alpha[:, None] * u_idx[None, :]
    q = torch.floor(au)
    return U, v, q, au - q


def _resample_pass(x, alpha, intercept, axis, out_len):
    """1-D bilinear resample along ``axis`` (2 = H, 3 = W) of (B, C, H, W)
    ``x``: output index u reads source position ``alpha*u + intercept``,
    ``alpha`` (B,), ``intercept`` (B, L_other). Returns ``axis`` at length
    ``out_len``."""
    src_len = x.shape[axis]
    U, v, q, r = _pass_geometry(alpha, intercept, out_len)
    Ui = U.to(torch.int32)
    xr = _per_line_roll(x, torch.remainder(Ui, src_len), axis)
    qi = q.to(torch.int32)
    src_iota = torch.arange(src_len, dtype=torch.int32, device=x.device)

    def tap(t):
        tgt = torch.remainder(qi + t, src_len)  # (B, out_len)
        onehot = (src_iota[None, :, None] == tgt[:, None, :]).to(x.dtype)
        if axis == 3:
            g = torch.einsum("bchw,bwv->bchv", xr, onehot)
            k = Ui[:, :, None] + qi[:, None, :] + t  # (B, H, V)
        else:
            g = torch.einsum("bchw,bhv->bcvw", xr, onehot)
            k = Ui[:, None, :] + qi[:, :, None] + t  # (B, V, W)
        valid = ((k >= 0) & (k <= src_len - 1)).to(x.dtype)
        return g * valid[:, None]

    g0, g1, g2 = tap(0), tap(1), tap(2)
    if axis == 3:
        e_in = r[:, None, :] + v[:, :, None]
    else:
        e_in = r[:, :, None] + v[:, None, :]
    e = torch.floor(e_in)
    f = (e_in - e)[:, None].to(x.dtype)
    e1 = (e == 1)[:, None]
    lo = torch.where(e1, g1, g0)
    hi = torch.where(e1, g2, g1)
    return (1.0 - f) * lo + f * hi


def _resample_pass_t(g, alpha, intercept, src_len):
    """Exact adjoint of ``_resample_pass(., alpha, intercept, 2, V)`` for
    (B, C, V, W) cotangents ``g``: weight each by its taps' lerp and validity
    coefficients, contract with the transposed one-hot selections, and undo
    the roll. Returns (B, C, src_len, W)."""
    out_len = g.shape[2]
    U, v, q, r = _pass_geometry(alpha, intercept, out_len)
    Ui, qi = U.to(torch.int32), q.to(torch.int32)
    e_in = r[:, :, None] + v[:, None, :]  # (B, V, W)
    e = torch.floor(e_in)
    f = (e_in - e).to(g.dtype)  # the forward lerps in the data type
    e1 = (e == 1).to(g.dtype)
    coefs = ((1.0 - f) * (1.0 - e1), (1.0 - f) * e1 + f * (1.0 - e1), f * e1)
    src_iota = torch.arange(src_len, dtype=torch.int32, device=g.device)
    acc = 0.0
    for t, coef in enumerate(coefs):
        tgt = torch.remainder(qi + t, src_len)  # (B, V)
        onehot = (src_iota[None, :, None] == tgt[:, None, :]).to(g.dtype)
        k = Ui[:, None, :] + qi[:, :, None] + t
        valid = ((k >= 0) & (k <= src_len - 1)).to(g.dtype)
        acc = acc + torch.einsum("bcvw,bsv->bcsw", g * (coef * valid)[:, None],
                                 onehot)
    return _per_line_roll(acc, torch.remainder(-Ui, src_len), 2)


def shear_geometry(M, w, out_h):
    """The two passes of the (B, 2, 3) pixel map ``M`` on a square source of
    side ``w``: (swap, delta, intercept_v, a, intercept_h), pass V reading
    ``delta*y + intercept_v[x']`` of the image (transposed where ``swap``),
    pass H reading ``a*j + intercept_h[y]``."""
    M = M.to(torch.float32)
    # transpose conditioning: |eps| = |c/a| <= 1 by warping the transposed
    # image (a row swap of M) when |c| > |a|
    swap = M[:, 1, 0].abs() > M[:, 0, 0].abs()
    M_eff = torch.where(swap[:, None, None], M.flip(1), M)
    a, b_sh, tx = M_eff[:, 0, 0], M_eff[:, 0, 1], M_eff[:, 0, 2]
    cc, d, ty = M_eff[:, 1, 0], M_eff[:, 1, 1], M_eff[:, 1, 2]
    # the degenerate |a| ~ 0 (a near-singular map) is clamped
    a_safe = torch.where(a.abs() < 1e-4,
                         torch.where(a < 0, -1e-4, 1e-4).to(a.dtype), a)
    eps = cc / a_safe
    delta = d - eps * b_sh
    zeta = ty - eps * tx
    xp = torch.arange(w, dtype=torch.float32, device=M.device)
    intercept_v = eps[:, None] * xp[None, :] + zeta[:, None]  # (B, W)
    yy = torch.arange(out_h, dtype=torch.float32, device=M.device)
    intercept_h = b_sh[:, None] * yy[None, :] + tx[:, None]  # (B, out_h)
    return swap, delta, intercept_v, a, intercept_h


def affine_warp_shear(x, M, out_hw=None, resample_rows=None):
    """Two-pass separable warp. x: (B, H, W, C) square; M: (B, 2, 3)
    pixel-space map.

    ``resample_rows`` None runs both passes as ``_resample_pass`` (the JAX
    package's 'xla' form); otherwise it is an op ``(x, alpha, intercept,
    out_len)`` resampling along rows (``ops.resample_rows``, the CUDA pass
    or its plain version), and the second pass runs on the swapped axes, as
    the JAX 'pallas' form does. Both give the same numbers: each output
    selects its taps exactly."""
    b, h, w, c = x.shape
    if h != w:
        raise ValueError("affine_warp_shear requires a square source image")
    out_h, out_w = out_hw or (h, w)
    x = x.permute(0, 3, 1, 2)  # (B, C, H, W)
    swap, delta, intercept_v, a, intercept_h = shear_geometry(M, w, out_h)
    x_eff = torch.where(swap[:, None, None, None], x.transpose(2, 3), x)

    if resample_rows is None:
        A = _resample_pass(x_eff, delta, intercept_v, axis=2, out_len=out_h)
        out = _resample_pass(A, a, intercept_h, axis=3, out_len=out_w)
    else:
        A = resample_rows(x_eff.contiguous(), delta.contiguous(),
                          intercept_v.contiguous(), out_h)
        At = A.transpose(2, 3).contiguous()  # rows := W for the second pass
        out = resample_rows(At, a.contiguous(), intercept_h.contiguous(),
                            out_w).transpose(2, 3)
    return out.permute(0, 2, 3, 1)  # back to NHWC


def affine_warp(x, M, out_hw=None, impl="shear", ops=None):
    """Batched affine warp. impl: 'shear' (the plain two-pass form),
    'shear_pallas' (the same passes through ``ops.resample_rows``: the CUDA
    kernel with ``KERNELS``), or 'exact' (the per-pixel gather)."""
    if impl == "exact":
        return affine_warp_exact(x, M, out_hw)
    if impl == "shear":
        return affine_warp_shear(x, M, out_hw)
    if impl == "shear_pallas":
        if ops is None:
            raise ValueError("affine_warp impl='shear_pallas' needs an op set")
        return affine_warp_shear(x, M, out_hw, ops.resample_rows)
    raise ValueError(f"unknown affine_warp impl: {impl!r}")
