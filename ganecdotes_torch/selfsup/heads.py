"""One-shot segmentor FCN heads (port of ganecdotes_tpu/selfsup/heads.py,
the dilated-conv family; the ``Lin`` variant and DatasetGAN's pixel
classifier are not ported yet).

Faithful quirk of the reference (hfc_with_swav/swav_clustering.py:697-758):
the layer list is built by ``zip(dilations, channels[:-1], channels[1:])``,
so the conv count equals ``len(dilations)`` and for XXS the n_class tail of
the channel list is never reached: the XXS head outputs 12 channels whatever
n_class is (argmax over the extra channels is harmless).

Params are a list of {"weight": (3,3,cin,cout) HWIO, "bias": (cout,)}.
"""

import torch

from ganecdotes_torch.nn.layers import conv2d_dilated_nhwc, leaky_relu

DILATIONS = {
    "XXS": [1],
    "XS": [1, 2, 1],
    "S": [1, 2, 1, 2, 1],
    "M": [1, 2, 4, 1, 2, 4, 1],
    "L": [1, 2, 4, 8, 1, 2, 4, 8, 1],
}

CHANNELS = {
    "XXS": [12],
    "XS": [16, 8],
    "S": [128, 64, 64, 32],
    "M": [128, 64, 64, 64, 64, 32],
    "L": [128, 64, 64, 64, 64, 64, 64, 32],
}


def segmentor_out_channels(n_class, size="S"):
    """Actual output channel count (reproduces the zip-truncation quirk)."""
    channels = [0] + CHANNELS[size] + [n_class]
    return channels[1:][len(DILATIONS[size]) - 1]


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_one_shot_segmentor(in_ch, n_class, size="S", generator=None):
    """Params for the FCN head: torch nn.Conv2d's default init,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) on weight and bias."""
    dilations = DILATIONS[size]
    channels = [in_ch] + CHANNELS[size] + [n_class]
    layers = []
    for _, cin, cout in zip(dilations, channels[:-1], channels[1:]):
        bound = 1.0 / (cin * 9) ** 0.5
        layers.append({
            "weight": _uniform((3, 3, cin, cout), bound, generator),
            "bias": _uniform((cout,), bound, generator),
        })
    return layers


def one_shot_segmentor_apply(params, x, size="S"):
    """x: (B, H, W, C) -> logits (B, H, W, C_out)."""
    dilations = DILATIONS[size]
    out = x
    for i, (p, d) in enumerate(zip(params, dilations)):
        out = conv2d_dilated_nhwc(out, p["weight"], dilation=d, padding=d)
        out = out + p["bias"].to(out.dtype)
        if i != len(params) - 1:  # layers[:-1] strips the final activation
            out = leaky_relu(out)
    return out
