"""The weights of a run, made from the seed on the device in one draw.

One ``torch.Generator`` on the device draws a single unit-normal vector as
long as all the weights together; each weight is a view of it, scaled as
its kind asks (``kind`` as ``reference.<name>.weight_shapes`` gives it).
The same seed gives the same weights on the same device.
"""

import math

import torch

SCALE = {"normal": 1.0, "small": 0.1, "mod_bias": 0.1, "zeros": 0.0, "ones": 0.0}
OFFSET = {"mod_bias": 1.0, "ones": 1.0}


def stream(seed, k):
    """A generator seed for the k-th stream of a run (weights, requests,
    ...), distinct for every (seed, k)."""
    return (int(seed) * 7919 + k) % (2**63 - 1)


def make(shapes, cfg, seed, device):
    """{name: float32 tensor on ``device``} for ``shapes`` ({name: (shape,
    kind)})."""
    gen = torch.Generator(device=device).manual_seed(stream(seed, 0))
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    off = 0
    for (name, (shape, kind)), n in zip(shapes.items(), sizes):
        v = flat[off : off + n].view(shape)
        off += n
        if kind == "linear_mlp":
            v = v / cfg["lr_mlp"]
        elif kind == "fan_in":
            v = v / math.sqrt(math.prod(shape[:-1]))
        else:
            v = v * SCALE[kind] + OFFSET.get(kind, 0.0)
        out[name] = v.contiguous()
    return out
