"""Carry weights across from the JAX package (its pytrees, as numpy arrays).

The port keeps the JAX layouts (HWIO conv weights, (in, out) linear weights,
NHWC buffers) and the JAX pytree's key names, so carrying a tree across is a
flatten and a load: no transposes. The caller converts its JAX arrays with
``numpy.asarray``; nothing here imports JAX.
"""

import numpy as np
import torch

from ganecdotes_torch.models.stylegan2.generator import Generator


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def from_jax_params(tree, device=None):
    """SwAV params or one-shot head params (nested dicts/lists of arrays or
    tensors) -> the same nesting of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def from_jax_generator_params(tree, blur_kernel=(1, 3, 3, 1), device=None):
    """A port ``Generator`` computing the same function as the JAX params.

    ``tree`` is the pytree of ``ganecdotes_tpu ... init_generator`` (or of a
    converted checkpoint) with numpy leaves. The architecture is read off the
    tree: size from the number of convs, channel widths per resolution.
    """
    n_up = len(tree["convs"]) // 2
    size = 4 * 2**n_up
    style_dim = np.shape(tree["style"][0]["weight"])[0]
    res2chlmap = {4: np.shape(tree["input"])[-1]}
    for i in range(n_up):
        res2chlmap[8 * 2**i] = np.shape(tree["convs"][2 * i]["bias"])[0]
    g = Generator(size, style_dim=style_dim, n_mlp=len(tree["style"]),
                  blur_kernel=blur_kernel, res2chlmap=res2chlmap,
                  generator=torch.Generator().manual_seed(0))
    state = {k: torch.as_tensor(np.array(v, dtype=np.float32))
             for k, v in _flatten(tree)}
    g.load_state_dict(state, strict=True)
    return g.to(device) if device is not None else g

