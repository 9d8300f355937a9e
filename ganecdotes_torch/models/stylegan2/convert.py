"""Carry weights across from the JAX package (its pytrees, as numpy arrays).

The port keeps the JAX layouts (HWIO conv weights, (in, out) linear weights,
NHWC buffers) and the JAX pytree's key names, so carrying a tree across is a
flatten and a load: no transposes. The caller converts its JAX arrays with
``numpy.asarray``; nothing here imports JAX.
"""

import numpy as np
import torch

from ganecdotes_torch.models.stylegan2.discriminator import Discriminator
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
    g.load_state_dict(tree_to_state(tree), strict=True)
    return g.to(device) if device is not None else g


def from_jax_discriminator_params(tree, blur_kernel=(1, 3, 3, 1), device=None):
    """A port ``Discriminator`` computing the same function as the JAX params
    of ``init_discriminator`` (numpy leaves); the architecture is read off
    the tree: size from the number of blocks, widths per resolution."""
    n_blocks = len(tree["blocks"])
    size = 4 * 2**n_blocks
    in_ch = np.shape(tree["conv_in"]["weight"])[2]
    res2chlmap = {size: np.shape(tree["conv_in"]["weight"])[3],
                  4: np.shape(tree["final_conv"]["weight"])[3]}
    for i, blk in enumerate(tree["blocks"]):
        res2chlmap[size // 2 ** (i + 1)] = np.shape(blk["conv2"]["weight"])[3]
    d = Discriminator(size, in_channels=in_ch, blur_kernel=blur_kernel,
                      res2chlmap=res2chlmap,
                      generator=torch.Generator().manual_seed(0))
    d.load_state_dict(tree_to_state(tree), strict=True)
    return d.to(device) if device is not None else d


def tree_to_state(tree):
    """A nested params tree (dicts and lists) -> a flat ``state_dict``."""
    return {k: torch.as_tensor(np.array(v, dtype=np.float32))
            for k, v in _flatten(tree)}


def module_tree(module):
    """A module's parameters and buffers as the JAX package's nested tree
    (dicts, with lists where the keys are indices), CPU tensors."""
    root = {}
    for name, t in module.state_dict().items():
        node, parts = root, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.detach().cpu()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
