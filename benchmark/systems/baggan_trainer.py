"""The system under test for the training cells: the port's ``BagGANHQ``
trainer, driven by the loop body of ``cli/train_baggan.py``: the native
``.npy`` loader's next batch, ``set_input``, ``optimize_parameters``. The
iterations held against the reference hand ``set_input`` the benchmark's
draws; every other iteration draws from the trainer's own generator, as
the CLI does.

The trainer is built from a configuration file (ADA's p pinned at the
configuration's ``augment_p``); the benchmark's initial weights of both
nets are then copied into it.
"""

from types import SimpleNamespace


def _run_config(cfg, out_dir):
    g_every, d_every = cfg["g_reg_every"], cfg["d_reg_every"]
    r2c = cfg.get("res2chlmap")
    return SimpleNamespace(
        is_train=True, out_dir=out_dir, checkpoint_dir=out_dir,
        image_size=cfg["size"], latent_dim=cfg["style_dim"],
        generator_params={"mlp_layers": cfg["n_mlp"]},
        chl_multiplier=cfg["channel_multiplier"], res2chlmap=r2c and {int(k): int(v) for k, v in r2c.items()},
        num_channels=cfg["num_channels"], batch_size=cfg["batch_size"],
        gan_mode=cfg["gan_mode"], wgangp_remat=cfg["wgangp_remat"],
        lr=cfg["lr"], beta1=cfg["beta1"],
        g_reg_every=g_every, d_reg_every=d_every,
        g_reg_ratio=g_every / (g_every + 1), d_reg_ratio=d_every / (d_every + 1),
        r1_lambda=cfg["r1_lambda"], ppl_lambda=cfg["ppl_lambda"],
        path_batch_shrink=cfg["path_batch_shrink"], ppl_decay=cfg["ppl_decay"],
        use_ppl=True, mixing_prob=cfg["mixing_prob"], augment=cfg["augment"],
        augment_p=cfg["augment_p"], ada_target=cfg["ada_target"],
        ada_length=500 * 1000, compute_dtype=cfg["compute_dtype"],
        losses_to_print=["g_gan", "d", "g_ppl"], lr_policy="linear",
        lr_params=dict(epoch_count=1, n_epochs=100, n_epochs_decay=100))


def build(cfg, weights, seed, device, out_dir):
    """The port's trainer on ``device`` at the benchmark's initial state."""
    import torch

    from ganecdotes_torch.gan.train import BagGANHQ

    gan = BagGANHQ(_run_config(cfg, out_dir), seed=seed, device=device)
    gan.setup_gan()
    own = params(gan)
    odd = sorted(set(own) ^ set(weights))
    if odd:
        raise KeyError(f"trainer and benchmark weights differ in {odd}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(weights[k])
    return gan


def loader(cfg, paths):
    """The CLI's loader: every file, the batch, one worker thread."""
    from ganecdotes_torch.runtime import NativeDataLoader

    s = cfg["size"]
    return NativeDataLoader(paths, cfg["batch_size"], s, s, cfg["num_channels"],
                            n_threads=1)


def draws(d):
    """The benchmark's draws of one iteration as the trainer takes them."""
    from ganecdotes_torch.gan.train import BagGANDraws

    return BagGANDraws(d["z"], d["inject_index"], d["d_noise"], d["d_fake_aug"],
                       d["d_real_aug"], d["gp_alpha"], d["r1_aug"], d["g_noise"],
                       d["g_aug"], d["ppl_z"], d["ppl_noise_imgs"])


def step(gan, batch, it, d=None):
    """One iteration of the CLI's loop body on a loaded batch: with the
    benchmark's draws ``d``, or with None the trainer's own."""
    gan.set_input(data_sample={"ct": batch}, iter_no=it,
                  draws=None if d is None else draws(d))
    gan.optimize_parameters()


def losses(gan, it, cfg):
    """The iteration's losses (a host sync), by step kind; NaN for a loss
    the trainer did not set."""
    kinds = {"d": "loss_d", "g": "loss_g_gan"}
    if it % cfg["d_reg_every"] == 0:
        kinds["r1"] = "loss_d_r1"
    if it % cfg["g_reg_every"] == 0:
        kinds["ppl"] = "loss_g_ppl"
    return {k: float(getattr(gan, a, float("nan"))) for k, a in kinds.items()}


def params(gan):
    """{name: tensor} of both nets' trained tensors (the generator's noise
    maps among them), the trainer's own."""
    out = {}
    for net in ("netG", "netD"):
        module = getattr(gan, net)
        for k, v in [*module.named_parameters(), *module.named_buffers()]:
            out[f"{net}.{k}"] = v
    return out


def watch_first_grads(gan):
    """Keep the gradient each of the first two steps of each optimiser
    hands it (D and R1 on D's, G and PPL on G's), read from its first
    moment after the step: m = (1 - b1) g + b1 m. Returns {kind: {name:
    gradient}}, filled as the steps run; ``unwatch`` restores the
    optimisers."""
    by_id = {id(v): k for k, v in params(gan).items()}
    names = {id(opt): [by_id.get(id(p)) for p in opt.params]
             for opt in (gan.optimizer_g, gan.optimizer_d)}
    kinds = {id(gan.optimizer_d): ("d", "r1"), id(gan.optimizer_g): ("g", "ppl")}
    got = {}

    def wrap(opt):
        orig = opt.step

        def step(grads):
            before = [m.clone() for m in opt.m]
            orig(grads)
            k = opt.count - 1
            if k < 2:
                got[kinds[id(opt)][k]] = {
                    n: (m - opt.b1 * b) / (1 - opt.b1)
                    for n, m, b in zip(names[id(opt)], opt.m, before) if n}
        opt.step = step
        opt._orig_step = orig

    for opt in (gan.optimizer_d, gan.optimizer_g):
        wrap(opt)
    return got


def watch_first_image(gan):
    """Keep the first image the trainer synthesises: iteration 0's D step,
    from the initial weights and the benchmark's draws (float32, NHWC).
    Returns {"image": tensor}, filled when it runs; ``unwatch`` restores
    the trainer."""
    got = {}
    orig = gan._synth

    def synth(*args, **kwargs):
        img = orig(*args, **kwargs)
        got.setdefault("image", img.detach().float().clone())
        return img

    gan._synth = synth
    return got


def unwatch(gan):
    gan.__dict__.pop("_synth", None)
    for opt in (gan.optimizer_d, gan.optimizer_g):
        if hasattr(opt, "_orig_step"):
            opt.step = opt._orig_step
            del opt._orig_step
