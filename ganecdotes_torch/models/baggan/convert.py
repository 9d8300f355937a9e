"""BagGAN checkpoints: the reference's ``%s_net_%s.pth`` state_dicts to a port
``Generator`` and back (port of ganecdotes_tpu/models/baggan/convert.py).

The reference's BagGAN-HQ generator is a second StyleGAN2 implementation
with its own module names (models/baggan/models.py:35-378, blocks.py) and a
leaner default width map (``BAGGAN_RES_TO_CHANNEL_MAP``). Its checkpoints
map onto the port's generator tree by layout transposes only:

  style.mapper.{i}.weight (out, in)     -> style[i-1].weight (in, out)
  const_input_block.const_block NCHW    -> input NHWC
  conv_init / conv_blks.{j}             -> conv1 / convs[j]
      .style_block.weight (1,o,i,k,k)   ->   .conv.weight HWIO
      .style_block.mod.{weight,bias}    ->   .conv.modulation
      .noise_block.weight (1,)          ->   .noise_weight ()
      .activation.bias                  ->   .bias
  x_to_img_init / x_to_img_blks.{j}     -> to_rgb1 / to_rgbs[j]
  noise_blks.noise_{l} (1,1,H,W)        -> noises[l] (1,H,W,1)

The widths are those of the state_dict, read off the tree.
"""

import math

import numpy as np
import torch

from ganecdotes_torch.models.stylegan2.convert import (
    _linear,
    _modconv,
    _t,
    from_jax_generator_params,
    module_tree,
)

# the reference's models/baggan/models.py:25-33 with its channel multiplier 2
BAGGAN_RES_TO_CHANNEL_MAP = {
    4: 512, 8: 512, 16: 256, 32: 128, 64: 64, 128: 32, 256: 16, 512: 8,
}
# the reference BagGAN's FIR taps, whose buffers its module registers
BLUR_KERNEL = (1, 3, 3, 1)


def _synthesis_block(sd, prefix):
    return {"conv": _modconv(sd, prefix + ".style_block", mod="mod"),
            "noise_weight": _t(sd[prefix + ".noise_block.weight"]).reshape(()),
            "bias": _t(sd[prefix + ".activation.bias"])}


def _x_to_img(sd, prefix):
    return {"conv": _modconv(sd, prefix + ".conv", mod="mod"),
            "bias": _t(sd[prefix + ".bias"]).reshape(-1)}


def baggan_generator_tree(sd, img_resolution):
    """A BagGAN ``StyleGANGenerator`` state_dict (a ``module.`` prefix from
    DataParallel is dropped) -> the generator tree (numpy leaves); ``n_mlp``
    is the number of ``style.mapper.*`` weights."""
    sd = {k.removeprefix("module."):
          (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    log_size = int(math.log2(img_resolution))
    n_mlp = sum(1 for k in sd
                if k.startswith("style.mapper.") and k.endswith(".weight"))
    return {
        # mapper index 0 is the parameter-free PixelNorm
        "style": [_linear(sd, f"style.mapper.{i}") for i in range(1, n_mlp + 1)],
        "input": np.transpose(_t(sd["const_input_block.const_block"]),
                              (0, 2, 3, 1)),
        "conv1": _synthesis_block(sd, "conv_init"),
        "to_rgb1": _x_to_img(sd, "x_to_img_init"),
        "convs": [_synthesis_block(sd, f"conv_blks.{j}")
                  for j in range(2 * (log_size - 2))],
        "to_rgbs": [_x_to_img(sd, f"x_to_img_blks.{j}")
                    for j in range(log_size - 2)],
        "noises": [np.transpose(_t(sd[f"noise_blks.noise_{l}"]), (0, 2, 3, 1))
                   for l in range((log_size - 2) * 2 + 1)],
    }


def convert_baggan_generator_state(sd, img_resolution, blur_kernel=BLUR_KERNEL):
    """A BagGAN generator state_dict -> a port ``Generator`` (on the CPU)
    with the state dict's widths."""
    return from_jax_generator_params(baggan_generator_tree(sd, img_resolution),
                                     blur_kernel=blur_kernel)


def load_baggan_torch_checkpoint(path, img_resolution, blur_kernel=BLUR_KERNEL):
    """A reference ``*_net_G.pth`` (a state_dict or a pickled module) -> a
    port ``Generator`` on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_baggan_generator_state(sd, img_resolution, blur_kernel)


def export_baggan_generator_state(gen):
    """A port ``Generator`` (or its tree) -> the reference ``StyleGANGenerator``
    state_dict (numpy values, NCHW, the reference's keys): the inverse of
    ``convert_baggan_generator_state``, plus what the reference's module
    registers beside the learned tensors: the FIR kernel buffers of every
    upsampling block and skip upsampler (outer(k, k) / sum * 4) and the
    4-conv mask head ``head_m`` that it builds but never calls (zeros)."""
    tree = module_tree(gen) if isinstance(gen, torch.nn.Module) else gen

    def arr(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                          np.float32)

    def lin(p):
        out = {"weight": arr(p["weight"]).T}
        if "bias" in p:
            out["bias"] = arr(p["bias"])
        return out

    def modconv(p):
        # HWIO -> (1, out, in, kh, kw)
        out = {"weight": np.transpose(arr(p["weight"]), (3, 2, 0, 1))[None]}
        out.update({"mod." + k: v for k, v in lin(p["modulation"]).items()})
        return out

    def synthesis(p):
        out = {"style_block." + k: v for k, v in modconv(p["conv"]).items()}
        out["noise_block.weight"] = arr(p["noise_weight"]).reshape(1)
        out["activation.bias"] = arr(p["bias"])
        return out

    def x_to_img(p):
        out = {"conv." + k: v for k, v in modconv(p["conv"]).items()}
        out["bias"] = arr(p["bias"]).reshape(1, -1, 1, 1)
        return out

    sd = {}
    for i, layer in enumerate(tree["style"]):
        for k, v in lin(layer).items():
            sd[f"style.mapper.{i + 1}.{k}"] = v
    sd["const_input_block.const_block"] = np.transpose(arr(tree["input"]),
                                                       (0, 3, 1, 2))
    sd.update({"conv_init." + k: v for k, v in synthesis(tree["conv1"]).items()})
    sd.update({"x_to_img_init." + k: v
               for k, v in x_to_img(tree["to_rgb1"]).items()})
    for j, blk in enumerate(tree["convs"]):
        sd.update({f"conv_blks.{j}.{k}": v for k, v in synthesis(blk).items()})
    for j, blk in enumerate(tree["to_rgbs"]):
        sd.update({f"x_to_img_blks.{j}.{k}": v for k, v in x_to_img(blk).items()})
    for l, n in enumerate(tree["noises"]):
        sd[f"noise_blks.noise_{l}"] = np.transpose(arr(n), (0, 3, 1, 2))

    k = np.asarray(BLUR_KERNEL, np.float32)
    k2 = np.outer(k, k)
    k_up = (k2 / k2.sum() * 4.0).astype(np.float32)
    for j in range(0, len(tree["convs"]), 2):  # the upsampling convs
        sd[f"conv_blks.{j}.style_block.blur.kernel"] = k_up
    for j in range(len(tree["to_rgbs"])):
        sd[f"x_to_img_blks.{j}.upsample.kernel"] = k_up
    for i in range(4):
        sd[f"head_m.{i}.weight"] = np.zeros((1, 1, 3, 3), np.float32)
        sd[f"head_m.{i}.bias"] = np.zeros((1,), np.float32)
    return sd


def save_baggan_torch_checkpoint(path, gen):
    """Write a port ``Generator`` (or its tree) as a reference ``*_net_G.pth``."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in export_baggan_generator_state(gen).items()}, path)
