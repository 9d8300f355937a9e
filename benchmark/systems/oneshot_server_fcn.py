"""The system under test for the serving cells whose head has several
convs (the XS head): the port's ``OneShotServer`` (hfc_with_swav, the
folded form), built as ``oneshot_server`` builds it, with every layer of
the head handed over (``head.<i>.weight``, ``head.<i>.bias``). A request
returns its outputs on the host (``serving.outputs_to_host``: the port's
copy through page-locked memory), as a bulk job stores them.
"""

from harness.registry import sibling

_base = sibling(__file__, "oneshot_server")
mean_latent_z = _base.mean_latent_z


def head_params(weights):
    """The head's layers, first to last, as the server takes them
    (copies: the reference reads the benchmark's tensors afterwards)."""
    out = []
    while f"head.{len(out)}.weight" in weights:
        i = len(out)
        out.append({"weight": weights[f"head.{i}.weight"].clone(),
                    "bias": weights[f"head.{i}.bias"].clone()})
    return out


def build(cfg, weights, seed, device):
    """The port's server on ``device``, serving ``cfg`` with ``weights``."""
    import torch

    from ganecdotes_torch.models.stylegan2 import generator
    from ganecdotes_torch.pipeline.serving import OneShotServer

    model, segmentor = _base._configs(cfg)
    dev = torch.device(device)
    # the module's own draws are thrown away: the benchmark's weights go in
    with torch.device(dev):
        gen = generator.Generator(**model.gen_args,
                                  generator=torch.Generator(dev).manual_seed(0))
    names = set(gen.state_dict())
    gen.load_state_dict({k: v for k, v in weights.items() if k in names})
    ssl = {"projection": [{"weight": weights["projection"].clone()}]}
    return OneShotServer(model, segmentor, device=dev, seed=seed, gen=gen,
                         ssl_params=ssl, seg_params=head_params(weights))


def serve(server, z):
    """One request: (image, labels, z0) on the host."""
    from ganecdotes_torch.pipeline.serving import outputs_to_host

    return outputs_to_host(server.serve(z))
