"""Plain reference of a BagGAN-HQ training iteration (avm-debatr/ganecdotes,
models/baggan, ``config_pidray_unlabeled``): StyleGAN2 G and D at 256 px,
WGAN-GP with the mixed penalty, lazy R1 every ``d_reg_every`` iterations,
the non-saturating WGAN G loss, lazy path-length regularisation every
``g_reg_every`` iterations, style mixing, ADA on D's inputs, and Adam with
the lazy-regularisation ratios.

Plain float32 PyTorch (TF32 off), NCHW, autograd for every gradient and
gradient of a gradient; no kernel, no recompute. Its departures from the
published code are the program's, kept so the two compute one function:

- ADA applies the inverse affine with a two-pass separable bilinear warp
  (a vertical shear pass, then a horizontal one; the image transposed
  first where |c| > |a|), between the SYM6 2x up and down passes, after a
  reflect pad of a quarter of the side plus the filter's margin;
- the generator's fixed noise maps are trained by G's Adam, as the JAX
  trainer's G tree holds them;
- every random number (latents, mixing, noise maps, ADA matrices, the
  penalty's alpha, the PPL probes) comes in with the iteration.
"""

import numpy as np
import torch
import torch.nn.functional as F

from reference.precision import rounder
from reference.stylegan2 import (
    Discriminator,
    Generator,
    discriminator_shapes,
    generator_shapes,
    upfirdn2d,
)

SYM6 = (
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
)


def weight_shapes(cfg):
    """{name: (shape, kind)}: the generator's weights under ``netG.`` and
    the discriminator's under ``netD.``, at StyleGAN2's initial state (unit
    normal weights, zero biases and noise strengths, modulation biases 1)."""
    shapes = {"netG." + k: v for k, v in generator_shapes(
        cfg, biases="zeros", mod_bias="ones", noise_weight="zeros").items()}
    shapes.update({"netD." + k: v for k, v in discriminator_shapes(cfg).items()})
    return shapes


# -- ADA ---------------------------------------------------------------------


def _mat(rows, device):
    return torch.tensor(rows, dtype=torch.float32, device=device)


def warp_matrix(G, h, w, len_k, pad_frac=0.25):
    """The (B, 2, 3) pixel map of the warp: output pixel (j, i) of the 2x
    padded image reads source pixel M @ (j, i, 1), for inverse affine
    matrices ``G`` in StyleGAN2-ADA's normalised coordinates."""
    dev = G.device
    pad_k = len_k // 4
    pad_x = int(round(w * pad_frac)) + pad_k * 2
    pad_y = int(round(h * pad_frac)) + pad_k * 2
    src_h, src_w = 2 * (h + 2 * pad_y), 2 * (w + 2 * pad_x)
    out_h, out_w = (h + pad_k * 2) * 2, (w + pad_k * 2) * 2
    g = _mat([[2, 0, 0], [0, 2, 0], [0, 0, 1]], dev) @ G @ _mat(
        [[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1]], dev)
    g = (_mat([[1, 0, -0.5], [0, 1, -0.5], [0, 0, 1]], dev) @ g
         @ _mat([[1, 0, 0.5], [0, 1, 0.5], [0, 0, 1]], dev))
    g = (_mat([[2 / src_w, 0, 0], [0, 2 / src_h, 0], [0, 0, 1]], dev) @ g
         @ _mat([[out_w / 2, 0, 0], [0, out_h / 2, 0], [0, 0, 1]], dev))
    a_out = _mat([[2.0 / out_w, 0.0, 1.0 / out_w - 1.0],
                  [0.0, 2.0 / out_h, 1.0 / out_h - 1.0], [0, 0, 1]], dev)
    a_in = _mat([[src_w / 2.0, 0.0, (src_w - 1.0) / 2.0],
                 [0.0, src_h / 2.0, (src_h - 1.0) / 2.0], [0, 0, 1]], dev)
    return (a_in @ g @ a_out)[:, :2, :], (out_h, out_w)


def resample(x, alpha, intercept, out_len, axis):
    """1-D bilinear resample of (B, C, H, W) ``x`` along ``axis`` (2 or 3):
    output u of line l reads position alpha[b] * u + intercept[b, l], zero
    outside the line. The position is split as the program splits it
    (floor of the intercept, floor of alpha * u, the sum of their
    fractions), so both choose the same taps and weights."""
    n = x.shape[axis]
    U = torch.floor(intercept)  # (B, L)
    v = intercept - U
    au = alpha[:, None] * torch.arange(out_len, dtype=torch.float32,
                                       device=x.device)[None, :]
    q = torch.floor(au)  # (B, out)
    r = au - q
    if axis == 3:  # lines are rows y, positions along x
        base = U[:, :, None] + q[:, None, :]  # (B, H, out)
        e_in = r[:, None, :] + v[:, :, None]
    else:  # lines are columns x, positions along y
        base = U[:, None, :] + q[:, :, None]  # (B, out, W)
        e_in = r[:, :, None] + v[:, None, :]
    e = torch.floor(e_in)
    f = (e_in - e)[:, None]
    k0 = base + e

    def tap(k):
        valid = ((k >= 0) & (k <= n - 1)).to(x.dtype)[:, None]
        idx = k.clamp(0, n - 1).long()[:, None].expand(
            -1, x.shape[1], -1, -1)
        return torch.gather(x, axis, idx) * valid

    return (1.0 - f) * tap(k0) + f * tap(k0 + 1)


def shear_warp(x, M, out_hw):
    """The affine warp of square (B, C, S, S) ``x`` by the pixel map ``M``
    as a vertical pass then a horizontal pass."""
    w = x.shape[3]
    out_h, out_w = out_hw
    swap = M[:, 1, 0].abs() > M[:, 0, 0].abs()
    M = torch.where(swap[:, None, None], M.flip(1), M)
    a, b_sh, tx = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    cc, d, ty = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    # a near-singular map (|a| ~ 0) is clamped for the shear's slope only
    a_safe = torch.where(a.abs() < 1e-4,
                         torch.where(a < 0, -1e-4, 1e-4).to(a.dtype), a)
    eps = cc / a_safe
    delta = d - eps * b_sh
    zeta = ty - eps * tx
    xp = torch.arange(w, dtype=torch.float32, device=x.device)
    yy = torch.arange(out_h, dtype=torch.float32, device=x.device)
    x = torch.where(swap[:, None, None, None], x.transpose(2, 3), x)
    A = resample(x, delta, eps[:, None] * xp[None, :] + zeta[:, None], out_h, 2)
    return resample(A, a, b_sh[:, None] * yy[None, :] + tx[:, None], out_w, 3)


def augment(img, G, C):
    """ADA's geometric then color transform of (B, 3, H, W) ``img``; ``G``
    (B, 3, 3) inverse affine matrices, ``C`` (B, 4, 4) color matrices."""
    k = np.asarray(SYM6, np.float32)
    len_k = len(k)
    h, w = img.shape[2:]
    pad_k = len_k // 4
    pad_x = int(round(w * 0.25)) + pad_k * 2
    pad_y = int(round(h * 0.25)) + pad_k * 2
    x = F.pad(img, [pad_x, pad_x, pad_y, pad_y], mode="reflect")
    up0, up1 = (len_k + 1) // 2, (len_k - 2) // 2
    taps, flipped = k.tolist(), k[::-1].tolist()
    x = upfirdn2d(x, taps, None, up=(2, 1), pad=(up0, up1, 0, 0))
    x = upfirdn2d(x, None, taps, up=(1, 2), pad=(0, 0, up0, up1))
    M, out_hw = warp_matrix(G.to(torch.float32), h, w, len_k)
    x = shear_warp(x, M, out_hw)
    d_p = -(len_k // 4) * 2
    dn0, dn1 = d_p + (len_k - 1) // 2, d_p + (len_k - 2) // 2
    x = upfirdn2d(x, flipped, None, down=(2, 1), pad=(dn0, dn1, 0, 0))
    x = upfirdn2d(x, None, flipped, down=(1, 2), pad=(0, 0, dn0, dn1))
    x = torch.einsum("bchw,bdc->bdhw", x, C[:, :3, :3])
    return x + C[:, :3, 3][:, :, None, None]


# -- optimiser ---------------------------------------------------------------


class Adam:
    """m = (1-b1) g + b1 m; v = (1-b2) g^2 + b2 v; p -= lr * m_hat /
    (sqrt(v_hat) + eps), with bias-corrected moments."""

    def __init__(self, params, lr, b1, b2, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.count = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = (1 - self.b1) * g + self.b1 * self.m[k]
            self.v[k] = (1 - self.b2) * g * g + self.b2 * self.v[k]
            p -= self.lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)


# -- the iteration -------------------------------------------------------------


class Trainer:
    """BagGAN-HQ training from the benchmark's initial weights, on
    ``device``. ``iteration`` takes the real batch (B, H, W, 3) in [-1, 1]
    and the iteration's draws (a dict of the fields the benchmark hands the
    program, NHWC) and returns its losses; ``first_grads`` keeps each step
    kind's gradients of the first iteration, ``first_image`` the first
    image it synthesises (the first D step's, NHWC)."""

    def __init__(self, cfg, weights, device, fmt="fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.q = rounder(fmt)
        self.gp = {k[5:]: v.detach().to(device, torch.float32).clone().requires_grad_()
                   for k, v in weights.items() if k.startswith("netG.")}
        self.dp = {k[5:]: v.detach().to(device, torch.float32).clone().requires_grad_()
                   for k, v in weights.items() if k.startswith("netD.")}
        self.G = Generator(cfg, self.gp, self.q)
        self.D = Discriminator(cfg, self.dp, self.q)
        g_rr = cfg["g_reg_every"] / (cfg["g_reg_every"] + 1)
        d_rr = cfg["d_reg_every"] / (cfg["d_reg_every"] + 1)
        self.adam_g = Adam(self.gp, cfg["lr"] * g_rr, cfg["beta1"], 0.99 ** g_rr)
        self.adam_d = Adam(self.dp, cfg["lr"] * d_rr, cfg["beta1"], 0.99 ** d_rr)
        self.mean_path_length = torch.zeros((), device=device)
        self.first_grads = {}
        self.first_image = {}

    def params(self):
        return {**{"netG." + k: v for k, v in self.gp.items()},
                **{"netD." + k: v for k, v in self.dp.items()}}

    def _apply(self, kind, loss, net):
        params, adam = (self.gp, self.adam_g) if net == "netG" else (self.dp, self.adam_d)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g.detach()
                 for k, g in zip(names, grads)}
        if kind not in self.first_grads:
            self.first_grads[kind] = {f"{net}.{k}": g for k, g in grads.items()}
        adam.step(grads)

    def synth(self, zs, noise, inject):
        ws = [self.G.mapping(z) for z in zs]
        n = self.G.n_latent
        if len(ws) == 1:
            latent = ws[0][:, None, :].expand(-1, n, -1)
        else:
            latent = torch.cat([ws[0][:, None, :].expand(-1, inject, -1),
                                ws[1][:, None, :].expand(-1, n - inject, -1)], 1)
        return self.G.synthesis(latent, noise)[0]

    def iteration(self, it, real, dr):
        cfg = self.cfg
        real = real.permute(0, 3, 1, 2).to(torch.float32)
        losses = {}
        # D step, WGAN-GP with the mixed penalty
        with torch.no_grad():
            fake = self.synth(dr["z"], dr["d_noise"], dr["inject_index"])
            self.first_image.setdefault("image", fake.permute(0, 2, 3, 1).clone())
            d_fake = augment(fake, *dr["d_fake_aug"])
            d_real = augment(real, *dr["d_real_aug"])
        loss_out = self.D(d_fake).mean()
        loss_ref = -self.D(d_real).mean()
        alpha = dr["gp_alpha"].permute(0, 3, 1, 2)
        x = (alpha * d_real + (1 - alpha) * d_fake).detach().requires_grad_()
        (gx,) = torch.autograd.grad(self.D(x).sum(), x, create_graph=True)
        norm = torch.linalg.vector_norm(gx.reshape(gx.shape[0], -1) + 1e-16, dim=1)
        gp = torch.mean((norm - 1.0) ** 2)
        loss = (loss_out + loss_ref) * 0.25 + gp * 0.5
        self._apply("d", loss, "netD")
        losses["d"] = float(loss.detach())
        # lazy R1
        if it % cfg["d_reg_every"] == 0:
            x = real.detach().requires_grad_()
            pred = self.D(augment(x, *dr["r1_aug"]))
            (gx,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
            penalty = gx.reshape(gx.shape[0], -1).square().sum(1).mean()
            loss = (cfg["r1_lambda"] / 2 * penalty * cfg["d_reg_every"]
                    + 0 * pred[0, 0])
            self._apply("r1", loss, "netD")
            losses["r1"] = float(loss.detach())
        # G step
        fake = self.synth(dr["z"], dr["g_noise"], dr["inject_index"])
        loss = -self.D(augment(fake, *dr["g_aug"])).mean()
        self._apply("g", loss, "netG")
        losses["g"] = float(loss.detach())
        # lazy path-length regularisation, through the fixed noise maps
        if it % cfg["g_reg_every"] == 0:
            w = self.G.mapping(dr["ppl_z"])
            lat = w[:, None, :].expand(-1, self.G.n_latent, -1)
            img = self.G.synthesis(lat)[0]
            probe = dr["ppl_noise_imgs"].permute(0, 3, 1, 2)
            (gl,) = torch.autograd.grad((img * probe).sum(), lat, create_graph=True)
            lengths = torch.sqrt(gl.square().sum(dim=2).mean(dim=1))
            path_mean = (self.mean_path_length + cfg["ppl_decay"]
                         * (lengths.mean() - self.mean_path_length))
            ppl = torch.mean((lengths - path_mean) ** 2)
            self._apply("ppl", cfg["ppl_lambda"] * cfg["g_reg_every"] * ppl,
                        "netG")
            self.mean_path_length = path_mean.detach()
            losses["ppl"] = float(ppl.detach())
        return losses
