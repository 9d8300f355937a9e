"""The BagGAN-HQ generator for the one-shot pipeline (port of
ganecdotes_tpu/models/baggan/__init__.py). It is a StyleGAN2 generator
(the port's ``Generator``) with the widths of its checkpoint, or of the run
config's ``res2chlmap`` when it is initialised at random; its training
engine is ``ganecdotes_torch.gan.train.BagGANHQ``."""

import glob
import os

from ganecdotes_torch.models.baggan.convert import (
    BAGGAN_RES_TO_CHANNEL_MAP,
    load_baggan_torch_checkpoint,
)
from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.models.stylegan2.generator import Generator
from ganecdotes_torch.utils.serialization import load_pytree
from ganecdotes_torch.utils.util import load_config


def _rank(path):
    """'latest' first, then the highest epoch number ('10' above '9')."""
    stem = os.path.basename(path).split("_net_")[0]
    if stem == "latest":
        return (2, 0)
    try:
        return (1, int(stem))
    except ValueError:
        return (0, 0)


def load_baggan_generator(model_config, generator=None, logger=None):
    """The generator of a BagGAN model config, on the CPU: the newest
    ``*_net_G.npz`` in the run config's ``checkpoint_dir`` (the trainers'
    format), else the newest reference ``*_net_G.pth`` there, else random
    weights from ``generator`` (a ``torch.Generator``) at ``gen_args``' or
    the run config's ``res2chlmap``. A loaded generator has its file's
    widths and draws nothing."""
    ga = dict(model_config.gen_args)
    size = ga.get("size", 256)
    blur_kernel = tuple(ga.get("blur_kernel", (1, 3, 3, 1)))
    # random-init widths: gen_args' map, else the run config's; "baggan"
    # names the reference BagGAN's lean map, None the rosinality one
    r2c = ga.get("res2chlmap")
    cfg_path = getattr(model_config, "config_path", None)
    baggan_cfg = None
    if cfg_path and os.path.exists(cfg_path):
        baggan_cfg = load_config(cfg_path, "baggan_config")
        if r2c is None:
            r2c = getattr(baggan_cfg, "res2chlmap", None)
    if r2c == "baggan":
        r2c = BAGGAN_RES_TO_CHANNEL_MAP
    if baggan_cfg is not None:
        ckpt_dir = baggan_cfg.checkpoint_dir
        ckpts = glob.glob(os.path.join(ckpt_dir, "*_net_G.npz"))
        if ckpts:
            best = max(ckpts, key=_rank)
            g = from_jax_generator_params(load_pytree(best),
                                          blur_kernel=blur_kernel)
            if logger:
                logger.info(f"Loaded BagGAN generator: {best}")
            return g
        ckpts = glob.glob(os.path.join(ckpt_dir, "*_net_G.pth"))
        if ckpts:
            best = max(ckpts, key=_rank)
            g = load_baggan_torch_checkpoint(best, size, blur_kernel)
            if logger:
                logger.info(f"Imported reference BagGAN generator: {best}")
            return g
    if logger:
        logger.warning("BagGAN checkpoint not found - using randomly "
                       "initialized generator weights")
    return Generator(size, style_dim=ga.get("style_dim", 512),
                     n_mlp=ga.get("n_mlp", 8),
                     channel_multiplier=ga.get("channel_multiplier", 2),
                     blur_kernel=blur_kernel, res2chlmap=r2c, generator=generator)
