"""Feature-emitting StyleGAN2 generator (port of
ganecdotes_tpu/models/stylegan2/generator.py).

``generator_forward`` returns the image and the feature pyramid (every
StyledConv activation, NHWC). The modulated convs run as
``demod * conv(x * s, W)`` with one shared HWIO weight, as in the JAX
package. The module tree mirrors the JAX parameter pytree key for key, so
``state_dict()`` names equal the pytree's flattened paths ("convs.3.conv.
weight", "noises.0", ...) and ``convert.from_jax_generator_params`` is a
plain load.

Every StyledConv goes through ``ops.styled_conv3x3`` / ``styled_up_conv3x3``,
the mapping's activations through ``ops.fused_leaky_relu`` and the to_rgb
skip upsamples through ``ops.upfirdn2d``, where ``ops`` is ``KERNELS``
(CUDA kernels, as autograd Functions, so gradients reach mapping and
synthesis) or ``PLAIN`` (their plain versions, the reference).
``dtype`` (``generator_forward``) runs the synthesis in that type, as the
JAX generator's ``dtype`` does (generator.py:388-394): the mapping and the
truncation stay float32, the w+ rows and the constant input are cast, and
every weight meets the activation in the activation's type (the styles s
and demod come out in it too: ``equal_linear_apply`` casts its weight to
the latent's type). With bfloat16 on the card the StyledConvs and the
to_rgb upsamples run their kernels' bf16 instances.
Random noise is passed in, never drawn inside the forward: ``make_noise``
draws the per-layer maps from a ``torch.Generator`` (JAX's threefry and
torch's RNG never agree, so a test hands both packages the same maps).
"""

import math

import torch
import torch.nn as nn

from ganecdotes_torch.nn.layers import EqualLinear, pixel_norm
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.ops.upfirdn2d import upsample_2d


def channel_map(channel_multiplier=2, res2chlmap=None):
    """Resolution -> channel width (ref model.py:484-494)."""
    if res2chlmap is not None:
        return dict(res2chlmap)
    return {
        4: 512,
        8: 512,
        16: 512,
        32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def num_feature_layers(size):
    """Number of StyledConv activations emitted: 1 + 2*(log2(size)-2)."""
    return 2 * (int(math.log2(size)) - 2) + 1


def generator_meta(size, style_dim=512, n_mlp=8, channel_multiplier=2,
                   blur_kernel=(1, 3, 3, 1), res2chlmap=None):
    """Static architecture record (pure config math)."""
    log_size = int(math.log2(size))
    meta = {
        "size": size,
        "style_dim": style_dim,
        "n_mlp": n_mlp,
        "channel_multiplier": channel_multiplier,
        "blur_kernel": tuple(blur_kernel),
        "n_latent": log_size * 2 - 2,
        "num_layers": (log_size - 2) * 2 + 1,
    }
    if res2chlmap is not None:
        meta["res2chlmap"] = dict(res2chlmap)
    return meta


# ---------------------------------------------------------------------------
# modules (names mirror the JAX pytree keys)
# ---------------------------------------------------------------------------


class ModulatedConv(nn.Module):
    """HWIO weight ~ N(0,1) plus the style -> per-input-channel modulation."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            kernel_size, kernel_size, in_ch, out_ch, generator=generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      generator=generator)

    def style_weight(self, style_w):
        """(s, scaled weight): s = modulation(w) (B, in), weight * 1/sqrt(fan_in)."""
        kh, kw, in_ch, _ = self.weight.shape
        s = self.modulation(style_w)
        return s, self.weight * (1.0 / math.sqrt(in_ch * kh * kw))


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, 3, style_dim, generator)
        self.noise_weight = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, style_w, noise, up=False, blur_kernel=(1, 3, 3, 1),
                ops=KERNELS):
        s, w = self.conv.style_weight(style_w)
        # demod[b,o] = rsqrt(sum_{khw,i} (W*s)**2 + 1e-8); the spatial sum of
        # W**2 is style-independent, so it is precontracted to (in, out)
        w_sq = w.square().sum(dim=(0, 1))
        demod = torch.rsqrt(s.square() @ w_sq.to(s.dtype) + 1e-8)
        if up:
            return ops.styled_up_conv3x3(x, w, s, demod, noise,
                                         self.noise_weight, self.bias,
                                         blur_kernel)
        return ops.styled_conv3x3(x, w, s, demod, noise, self.noise_weight,
                                  self.bias)


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv(in_ch, 3, 1, style_dim, generator)
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x, style_w, skip=None, blur_kernel=(1, 3, 3, 1),
                ops=KERNELS):
        # 1x1 modulated conv without demodulation: a per-pixel matmul
        s, w = self.conv.style_weight(style_w)
        out = (x * s[:, None, None, :].to(x.dtype)) @ w[0, 0].to(x.dtype)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + upsample_2d(skip, blur_kernel, impl=ops.upfirdn2d)
        return out


class _Buffers(nn.Module):
    """Indexable list of buffers named "0", "1", ... (fixed noise maps)."""

    def __init__(self, tensors):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(str(i), t)

    def __getitem__(self, i):
        return getattr(self, str(i))

    def __len__(self):
        return len(self._buffers)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class Generator(nn.Module):
    """StyleGAN2 generator, initialised from a ``torch.Generator``.

    Mirrors ganecdotes_tpu ``init_generator`` (ref Generator.__init__
    model.py:457-541): the same tensors under the same names, drawn from the
    given torch RNG on the CPU (so a seed gives the same weights on any
    machine); move the module with ``.to(device)``.
    """

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 blur_kernel=(1, 3, 3, 1), res2chlmap=None, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.meta = generator_meta(size, style_dim, n_mlp, channel_multiplier,
                                   blur_kernel, res2chlmap)
        channels = channel_map(channel_multiplier, res2chlmap)
        log_size = int(math.log2(size))

        self.style = nn.ModuleList(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, generator=g)
            for _ in range(n_mlp)
        )
        self.input = nn.Parameter(torch.randn(1, 4, 4, channels[4], generator=g))
        self.conv1 = StyledConv(channels[4], channels[4], style_dim, g)
        self.to_rgb1 = ToRGB(channels[4], style_dim, g)
        # fixed per-layer noise buffers (ref model.py:512-515), NHWC
        self.noises = _Buffers(
            torch.randn(1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1, generator=g)
            for i in range(self.meta["num_layers"])
        )
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, log_size + 1):
            out_ch = channels[2**i]
            self.convs.append(StyledConv(in_ch, out_ch, style_dim, g))
            self.convs.append(StyledConv(out_ch, out_ch, style_dim, g))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, g))
            in_ch = out_ch

    def forward(self, styles, **kwargs):
        return generator_forward(self, styles, **kwargs)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def mapping_apply(g, z, ops=KERNELS):
    """z -> w through PixelNorm + n_mlp equalized FC (ref model.py:473-482)."""
    x = pixel_norm(z)
    for layer in g.style:
        x = layer(x, activation="fused_lrelu", act=ops.fused_leaky_relu)
    return x


def make_noise(meta, batch=1, generator=None, device=None):
    """Random per-layer noise maps (ref model.py:543-552), NHWC (B, r, r, 1),
    drawn on the CPU from ``generator`` and moved to ``device``."""
    return [torch.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1,
                        generator=generator).to(device)
            for i in range(meta["num_layers"])]


def mean_latent(g, n_latent_samples, generator, ops=KERNELS):
    """Mean w over n style(z) samples (ref model.py:554-560); z is drawn on
    the CPU from ``generator`` and moved to the generator's device."""
    device = g.input.device
    z = torch.randn(n_latent_samples, g.meta["style_dim"], generator=generator)
    return mapping_apply(g, z.to(device), ops).mean(dim=0, keepdim=True)


def generator_forward(g, styles, input_is_latent=False, truncation=1.0,
                      truncation_latent=None, noise=None, randomize_noise=False,
                      inject_index=None, return_latents=False, ops=KERNELS,
                      dtype=None):
    """Full forward pass (ref Generator.forward, model.py:565-648).

    ``styles``: a list of one or two (B, style_dim) z (or w with
    ``input_is_latent``), or one (B, n_latent, style_dim) w-plus. Two styles
    mix: rows below ``inject_index`` take the first. ``noise`` is a list of
    per-layer (1 or B, H, W, 1) maps; None uses the fixed buffers, which
    ``randomize_noise=True`` refuses (pass the maps, from ``make_noise``).

    ``dtype`` (e.g. ``torch.bfloat16``) casts the w+ rows and the constant
    input, so the synthesis and its outputs run in it.

    Returns (image, features), (image, latent) with ``return_latents``, or
    (image, latent, features) with ``return_latents="all"``.
    """
    meta = g.meta
    blur_kernel = meta["blur_kernel"]
    n_latent = meta["n_latent"]
    if not isinstance(styles, (list, tuple)):
        styles = [styles]
    if not input_is_latent:
        mapped = []
        for s in styles:
            if s.dim() == 3:
                b, k, d = s.shape
                mapped.append(mapping_apply(g, s.reshape(b * k, d), ops).reshape(b, k, d))
            else:
                mapped.append(mapping_apply(g, s, ops))
        styles = mapped
    if noise is None:
        if randomize_noise:
            raise ValueError("randomize_noise=True needs the noise maps passed "
                             "in (make_noise)")
        noise = list(g.noises)
    if truncation < 1.0:
        styles = [truncation_latent + truncation * (s - truncation_latent)
                  for s in styles]
    if len(styles) == 1:
        s = styles[0]
        latent = s[:, None, :].expand(-1, n_latent, -1) if s.dim() < 3 else s
    else:
        if inject_index is None:
            raise ValueError("style mixing needs an inject_index")
        latent = torch.cat([
            styles[0][:, None, :].expand(-1, inject_index, -1),
            styles[1][:, None, :].expand(-1, n_latent - inject_index, -1)],
            dim=1)

    if dtype is not None:
        latent = latent.to(dtype)
    batch = latent.shape[0]
    out = g.input.expand(batch, -1, -1, -1)
    if dtype is not None:
        out = out.to(dtype)
    out = out.contiguous()
    out = g.conv1(out, latent[:, 0], noise[0], blur_kernel=blur_kernel, ops=ops)
    features = [out]
    skip = g.to_rgb1(out, latent[:, 1], blur_kernel=blur_kernel, ops=ops)

    i = 1
    for li in range(0, len(g.convs), 2):
        out = g.convs[li](out, latent[:, i], noise[1 + li], up=True,
                          blur_kernel=blur_kernel, ops=ops)
        features.append(out)
        out = g.convs[li + 1](out, latent[:, i + 1], noise[2 + li],
                              blur_kernel=blur_kernel, ops=ops)
        features.append(out)
        skip = g.to_rgbs[li // 2](out, latent[:, i + 2], skip,
                                  blur_kernel=blur_kernel, ops=ops)
        i += 2
    if return_latents == "all":
        return skip, latent, features
    if return_latents:
        return skip, latent
    return skip, features
