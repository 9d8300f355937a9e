"""Carry weights across from the JAX package (its pytrees, as numpy arrays),
and load the reference's PyTorch checkpoints.

The port keeps the JAX layouts (HWIO conv weights, (in, out) linear weights,
NHWC buffers) and the JAX pytree's key names, so carrying a tree across is a
flatten and a load: no transposes. The caller converts its JAX arrays with
``numpy.asarray``; nothing here imports JAX.

A reference checkpoint (rosinality layout: ``g_ema``, the discriminator) is
mapped onto that tree by the JAX package's layout transposes
(models/stylegan2/convert.py there), then loaded the same way:

  torch OIHW conv weights       -> HWIO
  torch (out, in) linear weights -> (in, out)
  NCHW buffers (const, noises)   -> NHWC
"""

import math

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


# ---------------------------------------------------------------------------
# reference (rosinality) checkpoints
# ---------------------------------------------------------------------------


def _np_state(sd):
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def _t(x):
    return np.asarray(x, dtype=np.float32)


def _linear(sd, prefix):
    p = {"weight": _t(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"])
    return p


def _modconv(sd, prefix, mod="modulation"):
    # torch weight (1, out, in, kh, kw) -> HWIO (kh, kw, in, out); the
    # modulation Linear is at ``prefix.mod`` (BagGAN names it "mod")
    w = _t(sd[prefix + ".weight"])[0]
    return {"weight": np.transpose(w, (2, 3, 1, 0)),
            "modulation": _linear(sd, f"{prefix}.{mod}")}


def _styled_conv(sd, prefix):
    return {"conv": _modconv(sd, prefix + ".conv"),
            "noise_weight": _t(sd[prefix + ".noise.weight"]).reshape(()),
            "bias": _t(sd[prefix + ".activate.bias"])}


def _to_rgb(sd, prefix):
    return {"conv": _modconv(sd, prefix + ".conv"),
            "bias": _t(sd[prefix + ".bias"]).reshape(3)}


def torch_generator_tree(sd, size, n_mlp=8):
    """A reference ``g_ema`` state_dict (tensors or arrays) -> the JAX
    package's generator tree (numpy leaves). A missing noise buffer becomes
    zeros, as in the JAX package."""
    sd = _np_state(sd)
    log_size = int(math.log2(size))
    tree = {
        "style": [_linear(sd, f"style.{i + 1}") for i in range(n_mlp)],
        # const input (1, C, 4, 4) -> (1, 4, 4, C)
        "input": np.transpose(_t(sd["input.input"]), (0, 2, 3, 1)),
        "conv1": _styled_conv(sd, "conv1"),
        "to_rgb1": _to_rgb(sd, "to_rgb1"),
        "convs": [_styled_conv(sd, f"convs.{i}")
                  for i in range(2 * (log_size - 2))],
        "to_rgbs": [_to_rgb(sd, f"to_rgbs.{i}") for i in range(log_size - 2)],
        "noises": [],
    }
    for layer_idx in range((log_size - 2) * 2 + 1):
        k = f"noises.noise_{layer_idx}"
        res = 2 ** ((layer_idx + 5) // 2)
        tree["noises"].append(
            np.transpose(_t(sd[k]), (0, 2, 3, 1)) if k in sd
            else np.zeros((1, res, res, 1), np.float32))
    return tree


def convert_torch_generator_state(sd, size, n_mlp=8):
    """A reference ``g_ema`` state_dict -> a port ``Generator`` (on the CPU)
    computing what the JAX package's converted params compute; the widths
    and the style dimension are read off the tree."""
    return from_jax_generator_params(torch_generator_tree(sd, size, n_mlp))


def torch_discriminator_tree(sd, size):
    """A reference Discriminator state_dict (convs.0 the input ConvLayer,
    convs.1..N the ResBlocks, final_conv, final_linear) -> the JAX package's
    discriminator tree (numpy leaves)."""
    sd = _np_state(sd)

    def conv(prefix, bias_prefix=None):
        p = {"weight": np.transpose(_t(sd[prefix + ".weight"]), (2, 3, 1, 0))}
        if bias_prefix and bias_prefix + ".bias" in sd:
            p["bias"] = _t(sd[bias_prefix + ".bias"])
        elif prefix + ".bias" in sd:
            p["bias"] = _t(sd[prefix + ".bias"])
        return p

    log_size = int(math.log2(size))
    return {
        # ConvLayer = Sequential(EqualConv2d, FusedLeakyReLU): the weight at
        # .0, the activation's bias at .1
        "conv_in": conv("convs.0.0", "convs.0.1"),
        "blocks": [{
            "conv1": conv(f"convs.{i}.conv1.0", f"convs.{i}.conv1.1"),
            # the downsampling ConvLayer = Sequential(Blur, EqualConv2d, Act)
            "conv2": conv(f"convs.{i}.conv2.1", f"convs.{i}.conv2.2"),
            "skip": conv(f"convs.{i}.skip.1"),
        } for i in range(1, log_size - 1)],
        "final_conv": conv("final_conv.0", "final_conv.1"),
        "final_lin1": _linear(sd, "final_linear.0"),
        "final_lin2": _linear(sd, "final_linear.1"),
    }


def convert_torch_discriminator_state(sd, size):
    """A reference Discriminator state_dict -> a port ``Discriminator`` (on
    the CPU) with the state_dict's widths."""
    return from_jax_discriminator_params(torch_discriminator_tree(sd, size))


def load_torch_checkpoint(path, size, n_mlp=8):
    """A reference ``.pt``: ``{'g_ema': state_dict, ...}`` or a bare
    state_dict -> a port ``Generator`` on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("g_ema", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_torch_generator_state(sd, size, n_mlp)
