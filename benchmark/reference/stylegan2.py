"""Plain reference of StyleGAN2's generator and discriminator (config-f
layout of rosinality's stylegan2-pytorch, Karras et al. 2020,
arXiv:1912.04958), NCHW, float32.

Written from the published architecture with no kernel and no fusion: the
mapping is pixel norm and equalized linear layers with a scaled leaky ReLU;
a modulated conv is rosinality's unfused form (x * s, conv, * demod); an up
conv is a stride-2 transposed conv and then the [1, 3, 3, 1] blur; to_rgb
is a 1x1 modulated conv without demodulation plus the upsampled skip. The
discriminator is the residual stack with blurred stride-2 convs, the
minibatch standard deviation and two equalized linear layers.

Weights are the benchmark's, keyed as the benchmark hands them to the
program: HWIO conv weights, (in, out) linear weights, NHWC noise maps. The
rounding ``q`` (``precision.rounder``) is applied to every operand of a
matmul or convolution: the identity for the reference, a lower precision
for its controls.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def channel_map(channel_multiplier=2, res2chlmap=None):
    if res2chlmap:
        return {int(k): int(v) for k, v in res2chlmap.items()}
    m = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


def generator_shapes(cfg, biases="small", mod_bias="mod_bias",
                     noise_weight="small"):
    """{name: (shape, kind)} of the generator's weights, in order. Kinds
    (``harness.weights``): ``normal``, ``linear_mlp`` (normal / lr_mlp), and
    the given kinds of the biases, modulation biases and noise strengths."""
    size, style = cfg["size"], cfg["style_dim"]
    ch = channel_map(cfg["channel_multiplier"], cfg.get("res2chlmap"))
    log_size = int(math.log2(size))
    shapes = {"input": ((1, 4, 4, ch[4]), "normal")}
    for i in range(cfg["n_mlp"]):
        shapes[f"style.{i}.weight"] = ((style, style), "linear_mlp")
        shapes[f"style.{i}.bias"] = ((style,), biases)

    def styled(prefix, cin, cout):
        shapes[f"{prefix}.noise_weight"] = ((), noise_weight)
        shapes[f"{prefix}.bias"] = ((cout,), biases)
        shapes[f"{prefix}.conv.weight"] = ((3, 3, cin, cout), "normal")
        shapes[f"{prefix}.conv.modulation.weight"] = ((style, cin), "normal")
        shapes[f"{prefix}.conv.modulation.bias"] = ((cin,), mod_bias)

    def to_rgb(prefix, cin):
        shapes[f"{prefix}.bias"] = ((3,), biases)
        shapes[f"{prefix}.conv.weight"] = ((1, 1, cin, 3), "normal")
        shapes[f"{prefix}.conv.modulation.weight"] = ((style, cin), "normal")
        shapes[f"{prefix}.conv.modulation.bias"] = ((cin,), mod_bias)

    styled("conv1", ch[4], ch[4])
    to_rgb("to_rgb1", ch[4])
    for i in range((log_size - 2) * 2 + 1):
        r = 2 ** ((i + 5) // 2)
        shapes[f"noises.{i}"] = ((1, r, r, 1), "normal")
    cin = ch[4]
    for k, res in enumerate(2 ** j for j in range(3, log_size + 1)):
        styled(f"convs.{2 * k}", cin, ch[res])
        styled(f"convs.{2 * k + 1}", ch[res], ch[res])
        to_rgb(f"to_rgbs.{k}", ch[res])
        cin = ch[res]
    return shapes


def discriminator_shapes(cfg):
    """{name: (shape, kind)} of the discriminator's weights (unit normal
    weights, zero biases, as StyleGAN2 initialises them); its widths are
    the channel multiplier's map."""
    size = cfg["size"]
    ch = channel_map(cfg["channel_multiplier"])
    shapes = {"conv_in.weight": ((1, 1, cfg["num_channels"], ch[size]), "normal"),
              "conv_in.bias": ((ch[size],), "zeros")}
    cin = ch[size]
    for k, i in enumerate(range(int(math.log2(size)), 2, -1)):
        cout = ch[2 ** (i - 1)]
        p = f"blocks.{k}"
        shapes[f"{p}.conv1.weight"] = ((3, 3, cin, cin), "normal")
        shapes[f"{p}.conv1.bias"] = ((cin,), "zeros")
        shapes[f"{p}.conv2.weight"] = ((3, 3, cin, cout), "normal")
        shapes[f"{p}.conv2.bias"] = ((cout,), "zeros")
        shapes[f"{p}.skip.weight"] = ((1, 1, cin, cout), "normal")
        cin = cout
    shapes["final_conv.weight"] = ((3, 3, ch[4] + 1, ch[4]), "normal")
    shapes["final_conv.bias"] = ((ch[4],), "zeros")
    shapes["final_lin1.weight"] = ((ch[4] * 16, ch[4]), "normal")
    shapes["final_lin1.bias"] = ((ch[4],), "zeros")
    shapes["final_lin2.weight"] = ((ch[4], 1), "normal")
    shapes["final_lin2.bias"] = ((1,), "zeros")
    return shapes


def fir_taps(taps, gain=1.0):
    """The 1-D taps of the separable FIR ``outer(taps, taps) / sum * gain``
    (either axis)."""
    k = np.asarray(taps, np.float64)
    return (k / k.sum() * math.sqrt(gain)).tolist()


def _fir1d(x, taps, axis):
    """Correlate ``x`` along ``axis`` with the reversed ``taps`` (a true
    convolution), keeping only the outputs every tap sees: shifted slices
    times each tap, summed. Plain elementwise work, differentiable to any
    order."""
    n = len(taps)
    out_len = x.shape[axis] - n + 1
    out = None
    for t, k in enumerate(reversed(taps)):
        y = x.narrow(axis, t, out_len) * float(k)
        out = y if out is None else out + y
    return out


def upfirdn2d(x, kx, ky, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)):
    """NCHW, the separable FIR with 1-D taps ``kx`` along x and ``ky`` along
    y (None: no filter on that axis): insert up - 1 zeros after each sample
    (x then y), pad (x0, x1, y0, y1) (negative pads crop), convolve, keep
    every down-th sample."""
    b, c, h, w = x.shape
    ux, uy = up
    if ux > 1 or uy > 1:
        xu = x.new_zeros(b, c, h * uy, w * ux)
        xu[:, :, ::uy, ::ux] = x
        x = xu
    x = F.pad(x, list(pad))
    if kx is not None:
        x = _fir1d(x, kx, 3)
    if ky is not None:
        x = _fir1d(x, ky, 2)
    return x[:, :, ::down[1], ::down[0]]


def lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


class Generator:
    """Mapping and synthesis over ``p`` ({name: tensor}, the generator's
    weights), with operand rounding ``q``."""

    def __init__(self, cfg, p, q):
        self.cfg, self.p, self.q = cfg, p, q
        self.log_size = int(math.log2(cfg["size"]))
        self.n_latent = self.log_size * 2 - 2
        self.k_up = fir_taps(cfg["blur_kernel"], 4.0)

    def linear(self, x, weight, scale):
        return self.q(x) @ self.q(weight * scale)

    def mapping(self, z):
        lr = self.cfg["lr_mlp"]
        x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        for i in range(self.cfg["n_mlp"]):
            wt = self.p[f"style.{i}.weight"]
            x = self.linear(x, wt, lr / math.sqrt(wt.shape[0]))
            x = lrelu(x + self.p[f"style.{i}.bias"] * lr)
        return x

    def style(self, prefix, w):
        wt = self.p[f"{prefix}.conv.modulation.weight"]
        return (self.linear(w, wt, 1.0 / math.sqrt(wt.shape[0]))
                + self.p[f"{prefix}.conv.modulation.bias"])

    def styled_conv(self, prefix, x, w, noise, up):
        s = self.style(prefix, w)
        hwio = self.p[f"{prefix}.conv.weight"]
        kh, kw, cin, _ = hwio.shape
        hwio = hwio / math.sqrt(cin * kh * kw)
        demod = torch.rsqrt((s[:, :, None] ** 2 * (hwio ** 2).sum((0, 1))[None])
                            .sum(1) + 1e-8)  # (B, Cout)
        xm = self.q(x * s[:, :, None, None])
        if up:
            out = F.conv_transpose2d(xm, self.q(hwio.permute(2, 3, 0, 1)), stride=2)
            out = out * demod[:, :, None, None]
            out = upfirdn2d(out, self.k_up, self.k_up, pad=(1, 1, 1, 1))
        else:
            out = F.conv2d(xm, self.q(hwio.permute(3, 2, 0, 1)), padding=1)
            out = out * demod[:, :, None, None]
        out = out + self.p[f"{prefix}.noise_weight"] * noise.permute(0, 3, 1, 2)
        out = out + self.p[f"{prefix}.bias"][None, :, None, None]
        return lrelu(out)

    def to_rgb(self, prefix, x, w, skip):
        s = self.style(prefix, w)
        hwio = self.p[f"{prefix}.conv.weight"]
        wt = hwio[0, 0] / math.sqrt(hwio.shape[2])  # (Cin, 3)
        out = torch.einsum("bchw,co->bohw", self.q(x * s[:, :, None, None]),
                           self.q(wt))
        out = out + self.p[f"{prefix}.bias"][None, :, None, None]
        if skip is not None:
            out = out + upfirdn2d(skip, self.k_up, self.k_up, up=(2, 2),
                                  pad=(2, 1, 2, 1))
        return out

    def noises(self):
        return [self.p[f"noises.{i}"] for i in range(2 * self.log_size - 3)]

    def synthesis(self, latent, noise=None):
        """latent (B, n_latent, style), noise the per-layer (1 or B, r, r, 1)
        maps (the fixed ones by default) -> image (B, 3, H, W) and the
        StyledConv maps."""
        noise = self.noises() if noise is None else noise
        b = latent.shape[0]
        x = self.p["input"].permute(0, 3, 1, 2).expand(b, -1, -1, -1)
        x = self.styled_conv("conv1", x, latent[:, 0], noise[0], up=False)
        feats = [x]
        skip = self.to_rgb("to_rgb1", x, latent[:, 1], None)
        for k in range(self.log_size - 2):
            i = 1 + 2 * k
            x = self.styled_conv(f"convs.{2 * k}", x, latent[:, i],
                                 noise[1 + 2 * k], up=True)
            feats.append(x)
            x = self.styled_conv(f"convs.{2 * k + 1}", x, latent[:, i + 1],
                                 noise[2 + 2 * k], up=False)
            feats.append(x)
            skip = self.to_rgb(f"to_rgbs.{k}", x, latent[:, i + 2], skip)
        return skip, feats


class Discriminator:
    """The residual discriminator over ``p`` ({name: tensor}), NCHW input,
    with operand rounding ``q``."""

    def __init__(self, cfg, p, q):
        self.cfg, self.p, self.q = cfg, p, q
        self.k = fir_taps(cfg["blur_kernel"])
        self.n_blocks = int(math.log2(cfg["size"])) - 2

    def conv(self, name, x, down=False, act=True):
        hwio = self.p[f"{name}.weight"]
        kh, kw, cin, _ = hwio.shape
        wt = self.q((hwio / math.sqrt(cin * kh * kw)).permute(3, 2, 0, 1))
        if down:
            pk = len(self.cfg["blur_kernel"]) - 2 + (kh - 1)
            p0, p1 = (pk + 1) // 2, pk // 2
            x = upfirdn2d(x, self.k, self.k, pad=(p0, p1, p0, p1))
            out = F.conv2d(self.q(x), wt, stride=2)
        else:
            out = F.conv2d(self.q(x), wt, padding=kh // 2)
        bias = self.p.get(f"{name}.bias")
        if bias is not None:
            out = out + bias[None, :, None, None]
        return lrelu(out) if act else out

    def __call__(self, x):
        """x (B, 3, H, W) -> logits (B, 1)."""
        out = self.conv("conv_in", x)
        for k in range(self.n_blocks):
            p = f"blocks.{k}"
            y = self.conv(f"{p}.conv1", out)
            y = self.conv(f"{p}.conv2", y, down=True)
            skip = self.conv(f"{p}.skip", out, down=True, act=False)
            out = (y + skip) / SQRT2
        b, c, h, w = out.shape
        group = min(b, 4)
        y = out.reshape(group, -1, 1, c, h, w)
        std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
        std = std.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)  # (B/g, 1, 1, 1)
        out = torch.cat([out, std.repeat(group, 1, h, w)], dim=1)
        out = self.conv("final_conv", out)
        out = out.reshape(b, -1)
        for name, act in (("final_lin1", True), ("final_lin2", False)):
            wt = self.p[f"{name}.weight"]
            out = (self.q(out) @ self.q(wt / math.sqrt(wt.shape[0]))
                   + self.p[f"{name}.bias"])
            out = lrelu(out) if act else out
        return out
