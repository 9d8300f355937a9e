"""One-shot segmentor heads (port of ganecdotes_tpu/selfsup/heads.py): the
dilated-conv FCN family with its linear ``Lin`` variant, and DatasetGAN's
per-pixel MLP classifier with BatchNorm.

Faithful quirk of the reference (hfc_with_swav/swav_clustering.py:697-758):
the layer list is built by ``zip(dilations, channels[:-1], channels[1:])``,
so the conv count equals ``len(dilations)`` and for XXS the n_class tail of
the channel list is never reached: the XXS head outputs 12 channels whatever
n_class is (argmax over the extra channels is harmless).

FCN params are a list of {"weight": (3,3,cin,cout) HWIO, "bias": (cout,)};
the ``Lin`` head is one {"weight": (cin, n_class), "bias"}. The pixel
classifier's BatchNorm state is an explicit list of
{"mean", "var", "gamma", "beta"} dicts, one per hidden layer, threaded
through ``pixel_classifier_apply`` as the JAX package threads it.
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
    if size == "Lin":
        return n_class
    channels = [0] + CHANNELS[size] + [n_class]
    return channels[1:][len(DILATIONS[size]) - 1]


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def torch_linear_init(cin, cout, bias=True, generator=None):
    """torch nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in)) on weight
    (in, out) and bias."""
    bound = 1.0 / cin**0.5
    p = {"weight": _uniform((cin, cout), bound, generator)}
    if bias:
        p["bias"] = _uniform((cout,), bound, generator)
    return p


def init_one_shot_segmentor(in_ch, n_class, size="S", generator=None):
    """Params for the head, ``size`` in {XXS, XS, S, M, L, Lin}: torch
    nn.Conv2d's (nn.Linear's for Lin) default init, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) on weight and bias."""
    if size == "Lin":
        return [torch_linear_init(in_ch, n_class, generator=generator)]
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


def one_shot_segmentor_apply(params, x, size="S", first_conv=None):
    """x: (B, H, W, C) -> logits (B, H, W, C_out).

    ``first_conv(x, w)``, when given, computes the first (dilation 1) conv in
    place of ``F.conv2d`` (the fine-tune of a wide input takes the matmul
    form, ``embed._conv3x3``)."""
    if size == "Lin":
        p = params[0]
        out = x @ p["weight"].to(x.dtype) + p["bias"].to(x.dtype)
        return leaky_relu(out)  # the Lin variant keeps its trailing LeakyReLU
    dilations = DILATIONS[size]
    out = x
    for i, (p, d) in enumerate(zip(params, dilations)):
        if i == 0 and first_conv is not None:
            out = first_conv(out, p["weight"].to(out.dtype))
        else:
            out = conv2d_dilated_nhwc(out, p["weight"], dilation=d, padding=d)
        out = out + p["bias"].to(out.dtype)
        if i != len(params) - 1:  # layers[:-1] strips the final activation
            out = leaky_relu(out)
    return out


# ---------------------------------------------------------------------------
# DatasetGAN pixel classifier
# ---------------------------------------------------------------------------


def init_pixel_classifier(in_ch, n_class, generator=None):
    """(params, BN state) of the MLP, widths keyed on n_class < 32 (ref
    baseline/datasetgan/segmentor.py:12-36); torch nn.Linear init, BN at
    mean 0, var 1, gamma 1, beta 0."""
    widths = ([in_ch, 128, 32, n_class] if n_class < 32
              else [in_ch, 256, 128, n_class])
    layers = [torch_linear_init(cin, cout, generator=generator)
              for cin, cout in zip(widths[:-1], widths[1:])]
    state = [{"mean": torch.zeros(w), "var": torch.ones(w),
              "gamma": torch.ones(w), "beta": torch.zeros(w)}
             for w in widths[1:-1]]
    return layers, state


def pixel_classifier_from_first(params, state, v, eps=1e-5):
    """The eval-mode classifier from after its first Linear: ``v`` is
    x @ W1 + b1 (pre-ReLU), any leading shape, so serving can fold the first
    Linear into the feature pyramid (``embed.project_feature_maps``). Each
    eval-mode BN sits between a ReLU and the next Linear and folds into it:
    (u s + t) @ W + b = u @ (s[:, None] W) + (t @ W + b)."""
    dt = v.dtype
    out = torch.clamp(v, min=0.0)
    for i in range(len(params) - 1):
        bn = state[i]
        s = bn["gamma"] * torch.rsqrt(bn["var"] + eps)
        t = bn["beta"] - bn["mean"] * s
        p = params[i + 1]
        w = p["weight"] * s[:, None]
        b = p["bias"] + t @ p["weight"]
        out = out @ w.to(dt) + b.to(dt)
        if i + 1 < len(params) - 1:
            out = torch.clamp(out, min=0.0)
    return out


def pixel_classifier_apply(params, state, x, train=False, momentum=0.1,
                           eps=1e-5):
    """x: (B, H, W, C) -> (logits (B, H, W, n_class), new state).

    Linear -> ReLU -> BatchNorm1d per hidden layer (the reference's order).
    Train mode normalises with the batch's statistics (biased variance) and
    moves the running stats by ``momentum`` toward the batch mean and the
    unbiased variance n/(n-1) var, as torch's BatchNorm1d does; the new
    state carries no gradient. Eval mode normalises with the running stats
    and returns the state unchanged."""
    b, h, w, c = x.shape
    v = x.reshape(-1, c)
    new_state = []
    for i, p in enumerate(params[:-1]):
        v = v @ p["weight"].to(v.dtype) + p["bias"].to(v.dtype)
        v = torch.clamp(v, min=0.0)
        bn = state[i]
        if train:
            mu = v.mean(dim=0)
            var = v.var(dim=0, unbiased=False)
            n = v.shape[0]
            unbiased = var.detach() * n / max(n - 1, 1)
            new_state.append({
                "mean": (1 - momentum) * bn["mean"] + momentum * mu.detach(),
                "var": (1 - momentum) * bn["var"] + momentum * unbiased,
                "gamma": bn["gamma"], "beta": bn["beta"]})
        else:
            mu, var = bn["mean"], bn["var"]
            new_state.append(bn)
        v = (v - mu) * torch.rsqrt(var + eps) * bn["gamma"] + bn["beta"]
    p = params[-1]
    v = v @ p["weight"].to(v.dtype) + p["bias"].to(v.dtype)
    return v.reshape(b, h, w, -1), new_state
