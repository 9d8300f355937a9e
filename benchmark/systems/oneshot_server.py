"""The system under test for the serving cells: the port's
``OneShotServer`` (hfc_with_swav, the folded form), built from a
configuration file and the benchmark's weights.

The benchmark hands the server the generator's weights, the projection and
the head; the server derives the rest itself (the mean latent of
``num_latents_for_mean`` z drawn from ``seed``).
"""

from types import SimpleNamespace


def _configs(cfg):
    seg = cfg["segmentor"]
    gen_args = dict(size=cfg["size"], style_dim=cfg["style_dim"],
                    n_mlp=cfg["n_mlp"],
                    channel_multiplier=cfg["channel_multiplier"],
                    blur_kernel=tuple(cfg["blur_kernel"]))
    if cfg.get("res2chlmap"):
        gen_args["res2chlmap"] = {int(k): int(v)
                                  for k, v in cfg["res2chlmap"].items()}
    model = SimpleNamespace(
        gen_args=gen_args, truncation=cfg["truncation"],
        num_latents_for_mean=cfg["num_latents_for_mean"],
        classes=[str(i) for i in range(cfg["label_classes"])],
        inference_dtype=cfg["inference_dtype"])
    swav_args = dict(hlen=seg["hlen"], nclasses=seg["nclasses"],
                     projn_nw=seg["projn_nw"], hf_interp=seg["hf_interp"],
                     nprototypes=seg["nprototypes"])
    segmentor = SimpleNamespace(hfc_prep_args=dict(swav_args=swav_args),
                                seg_args=dict(size=seg["seg_size"]))
    return model, segmentor


def build(cfg, weights, seed, device):
    """The port's server on ``device``, serving ``cfg`` with ``weights``."""
    import torch

    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.pipeline.serving import OneShotServer

    model, segmentor = _configs(cfg)
    dev = torch.device(device)
    # the module's own draws are thrown away: the benchmark's weights go in
    with torch.device(dev):
        gen = Generator(**model.gen_args,
                        generator=torch.Generator(dev).manual_seed(0))
    names = set(gen.state_dict())
    gen.load_state_dict({k: v for k, v in weights.items() if k in names})
    # copies: the reference reads the benchmark's tensors afterwards
    ssl = {"projection": [{"weight": weights["projection"].clone()}]}
    head = [{"weight": weights["head.weight"].clone(),
             "bias": weights["head.bias"].clone()}]
    return OneShotServer(model, segmentor, device=dev, seed=seed, gen=gen,
                         ssl_params=ssl, seg_params=head)


def mean_latent_z(cfg, seed):
    """The z the server averages for its mean latent: ``OneShotServer``
    draws them on the host from ``torch.Generator().manual_seed(seed * 4 +
    1)``; the reference maps the same z again."""
    import torch

    gen = torch.Generator().manual_seed(seed * 4 + 1)
    return torch.randn(cfg["num_latents_for_mean"], cfg["style_dim"],
                       generator=gen)


def serve(server, z):
    """One request: (image, labels, z0) on the device."""
    return server.serve(z)
