"""SwAV projection at inference (port of the serving subset of
ganecdotes_tpu/selfsup/swav.py: params, ``projection_tail`` and
``swav_predict_from_features``). Pretraining, with its Sinkhorn kernel, is
a later slice.

Params: {"projection": [{"weight": (hlen, nclasses)}, ...],
"prototype": {"weight": (nclasses, nprototypes), "bias": (nprototypes,)}}.
"""

import torch

from ganecdotes_torch.selfsup.embed import project_feature_maps


def _torch_linear_init(cin, cout, bias, generator):
    # torch nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in))
    bound = 1.0 / cin**0.5
    p = {"weight": (torch.rand(cin, cout, generator=generator) * 2 - 1) * bound}
    if bias:
        p["bias"] = (torch.rand(cout, generator=generator) * 2 - 1) * bound
    return p


def _bn_init(n):
    return {"gamma": torch.ones(n), "beta": torch.zeros(n),
            "mean": torch.zeros(n), "var": torch.ones(n)}


def init_swav_params(hlen, nclasses, nprototypes, projn_nw="linear",
                     generator=None):
    """Projection (linear | 1-layer | 2-layer, swav_clustering.py:244-269)
    + prototype Linear(nclasses, nprototypes) (:270-271)."""
    if projn_nw in ("linear", "1-layer"):
        projection = [_torch_linear_init(hlen, nclasses, False, generator)]
    elif projn_nw == "2-layer":
        projection = [
            _torch_linear_init(hlen, nclasses, False, generator),
            _bn_init(nclasses),
            _torch_linear_init(nclasses, nclasses, False, generator),
            _bn_init(nclasses),
        ]
    else:
        raise ValueError(f"unknown projn_nw {projn_nw}")
    prototype = _torch_linear_init(nclasses, nprototypes, True, generator)
    return {"projection": projection, "prototype": prototype}


def projection_tail(params, z, projn_nw, train=True, eps=1e-5):
    """Everything after the (level-decomposed) first linear layer.

    nn.LeakyReLU's default slope is 0.01. The 2-layer head's BatchNorm uses
    batch statistics in train mode.
    """
    if projn_nw == "linear":
        return z
    if projn_nw == "1-layer":
        return torch.where(z >= 0, z, 0.01 * z)
    bn1, lin2, bn2 = params["projection"][1:4]
    flat = z.reshape(-1, z.shape[-1])
    if train:
        mu, var = flat.mean(0), flat.var(0, unbiased=False)
    else:
        mu, var = bn1["mean"], bn1["var"]
    h = (flat - mu) * torch.rsqrt(var + eps) * bn1["gamma"] + bn1["beta"]
    h = torch.where(h >= 0, h, 0.01 * h)
    h = h @ lin2["weight"]
    if train:
        mu2, var2 = h.mean(0), h.var(0, unbiased=False)
    else:
        mu2, var2 = bn2["mean"], bn2["var"]
    h = (h - mu2) * torch.rsqrt(var2 + eps) * bn2["gamma"] + bn2["beta"]
    return torch.tanh(h).reshape(z.shape)


def swav_predict_from_features(ssl_params, features, hlen, nclasses,
                               projn_nw="linear", interp="nearest"):
    """Raw projection scores (B, H, W, nclasses) at full resolution; labels
    are their argmax. Only the projection is applied (no prototypes).

    The reference never calls .eval() on the projection head, so its
    BatchNorm keeps using batch statistics at predict time (train=True).
    """
    z = project_feature_maps(features, ssl_params["projection"][0]["weight"],
                             hlen=hlen, interp=interp)
    return projection_tail(ssl_params, z, projn_nw, train=True)
