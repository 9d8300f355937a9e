"""The port's GAN trainer (gan/losses.py, gan/train.py, the generator's style
mixing and noise) held against the JAX package on the CPU.

Random numbers are passed in: the port's steps take a ``BagGANDraws``
record, and ``_jax_draws`` rebuilds the draws the JAX steps make from their
keys by the split sequence of ganecdotes_tpu/gan/train.py (d_step :478 and
d_loss_fn :416, r1_step's key, g_loss_fn :519, ppl_step :538; augment
splits its key into the affine and the color draw, ada.py:317). The JAX
side composes its losses from the package's public functions exactly as
train.py:415-581 does and differentiates them with ``jax.grad``.

Small sizes: 16x16 images, latent 32, B 2, narrow widths (the generator
through ``res2chlmap``; the discriminator a narrow numpy tree, as in
tests/test_torch_discriminator.py).

Tolerances (float32 on both sides, sums in another order): losses 1e-5
absolute + 1e-4 relative; per-parameter gradients 1e-3 of the largest
element of the JAX gradient, plus 1e-4 of the largest element of the
whole step's gradient. Those gradients are sums over every pixel of the
batch, through up to two backward passes of the discriminator, ADA and the
synthesis, with terms of both signs: an element 100x below the tensor's
largest loses about two digits to cancellation (observed: at most 2e-4 of
the largest element, on a few such elements; most agree to 1e-6). Tensors
whose R1 gradient is nearly zero (the biases, which reach the gradient
norm only through the minibatch-stddev branch, ~1e-6) differ by up to 3e-5
of the step's largest element (the port's float64 run agrees with its
float32 run there, so this is the JAX side's rounding); the step-wide
term covers them. Adam against optax on equal gradients 1e-6.
"""

import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganecdotes_tpu.gan import ada as jada
from ganecdotes_tpu.gan import losses as jl
from ganecdotes_tpu.models.stylegan2 import discriminator as jd
from ganecdotes_tpu.models.stylegan2 import generator as jg
from ganecdotes_tpu.utils import serialization as jser
from ganecdotes_torch.gan import losses as tl
from ganecdotes_torch.gan import train as tt
from ganecdotes_torch.models.stylegan2 import convert
from ganecdotes_torch.models.stylegan2 import generator as tg
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.utils import tracing

from test_torch_discriminator import disc_tree, one_torch_thread  # noqa: F401

jtrain = importlib.import_module("ganecdotes_tpu.gan.train")

LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
SIZE, LAT, B = 16, 32, 2
WIDTHS = {4: 16, 8: 12, 16: 8}
P = 0.6  # ADA probability of the draws


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfg(tmp_path, **overrides):
    cfg = types.SimpleNamespace(
        out_dir=str(tmp_path), checkpoint_dir=str(tmp_path / "ckpt"),
        is_train=True, image_size=SIZE, latent_dim=LAT, num_channels=3,
        batch_size=B, gan_mode="wgangp", use_ppl=True, r1_lambda=10,
        ppl_lambda=2, path_batch_shrink=2, ppl_decay=0.01, d_reg_every=4,
        g_reg_every=4, mixing_prob=0.9, chl_multiplier=1, res2chlmap=WIDTHS,
        g_reg_ratio=4 / 5, d_reg_ratio=16 / 17, augment=True, augment_p=0,
        ada_target=0.6, ada_length=100, lr=0.002, beta1=0.0,
        lr_policy="linear", lr_params=dict(epoch_count=1, n_epochs=2, n_epochs_decay=2),
        generator_params=dict(mlp_layers=2), losses_to_print=["g_gan", "d", "g_ppl"],
        start_epoch=1, continue_train=False, load_net=False,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


# JAX's inits and draws run jitted: eager dispatch of their hundreds of
# small random ops costs tens of seconds on the CPU
_j_init_generator = jax.jit(lambda k: jg.init_generator(
    k, SIZE, style_dim=LAT, n_mlp=2, channel_multiplier=1, res2chlmap=WIDTHS)[0])


def _jax_generator(seed=0):
    meta = jg.generator_meta(SIZE, style_dim=LAT, n_mlp=2, channel_multiplier=1,
                             res2chlmap=WIDTHS)
    # nonzero noise weights, so the noise maps reach the output
    params = dict(_j_init_generator(jax.random.PRNGKey(seed)))
    for i, c in enumerate(params["convs"]):
        params["convs"][i] = dict(c, noise_weight=jnp.asarray(0.1 * (i + 1), jnp.float32))
    params["conv1"] = dict(params["conv1"], noise_weight=jnp.asarray(0.2, jnp.float32))
    return params, meta


def _trainer(tmp_path, g_params, d_tree, **overrides):
    """A CPU BagGANHQ holding the JAX nets' weights (D narrowed to the tree)."""
    gan = tt.BagGANHQ(_cfg(tmp_path, **overrides), device="cpu")
    gan.netG.load_state_dict(convert.tree_to_state(jax.tree.map(np.asarray, g_params)))
    gan.netD = convert.from_jax_discriminator_params(d_tree)
    gan.d_tensors = list(gan.netD.parameters())
    cfg = gan.config
    gan.optimizer_d = tt.Adam(gan.d_tensors, cfg.lr * cfg.d_reg_ratio, b1=cfg.beta1,
                              b2=0.99**cfg.d_reg_ratio)
    return gan


@jax.jit
def _j_aug_draws(key):
    k1, k2 = jax.random.split(key)
    return (jnp.linalg.inv(jada.sample_affine(k1, P, B, SIZE, SIZE)),
            jada.sample_color(k2, P, B))


def _aug_draws(key):
    """augment's (G, C) from its key (ada.py:317 split, :282 inverse)."""
    return tuple(_t(m) for m in _j_aug_draws(key))


_j_noise = jax.jit(lambda k: jg.make_noise(jg.generator_meta(SIZE), k, B))


def _noise(key):
    return [_t(n) for n in _j_noise(key)]


def _jax_draws(keys, zs, inject, ppl_z):
    """The port's BagGANDraws for the JAX steps' keys kd, kr, kg, kp."""
    kd, kr, kg, kp = keys
    kz, kdd = jax.random.split(kd)
    k1, k2, k3 = jax.random.split(kdd, 3)
    kzg, ka = jax.random.split(kg)
    _, kn = jax.random.split(kp)
    noise_imgs = jax.random.normal(kn, (ppl_z.shape[0], SIZE, SIZE, 3)) / float(SIZE)
    return tt.BagGANDraws(
        z=[_t(z) for z in zs], inject_index=inject,
        d_noise=_noise(kz),
        d_fake_aug=_aug_draws(k1), d_real_aug=_aug_draws(k2),
        gp_alpha=_t(jax.random.uniform(k3, (B, 1, 1, 1))),
        r1_aug=_aug_draws(kr),
        g_noise=_noise(kzg),
        g_aug=_aug_draws(ka), ppl_z=_t(ppl_z), ppl_noise_imgs=_t(noise_imgs))


def _jax_step_losses(meta, d_meta, cfg, real, zs, inject, ppl_z):
    """The JAX trainer's per-step losses (train.py:392-581) as functions of
    the params, with the same keys."""
    n_latent = meta["n_latent"]
    adv = jl.gan_loss(cfg.gan_mode)

    def synth(gp, key):
        ws = [jg.mapping_apply(gp, z) for z in zs]
        if len(ws) == 1:
            lat = jnp.repeat(ws[0][:, None, :], n_latent, axis=1)
        else:
            rows = jnp.arange(n_latent)[None, :, None]
            lat = jnp.where(rows < inject, ws[0][:, None, :], ws[1][:, None, :])
        return jg.generator_forward(gp, meta, [lat], input_is_latent=True,
                                    randomize_noise=True, noise_key=key,
                                    return_latents=True)[0]

    def aug(x, key):
        if not cfg.augment:
            return x
        return jada.augment(x, P, key, warp_impl="shear")[0]

    def d_loss(dp, gp, key):
        kz, kd = jax.random.split(key)
        fake = jax.lax.stop_gradient(synth(gp, kz))
        k1, k2, k3 = jax.random.split(kd, 3)
        d_fake, d_real = aug(fake, k1), aug(real, k2)
        lo = adv(jd.discriminator_forward(dp, d_meta, d_fake), False)
        lr_ = adv(jd.discriminator_forward(dp, d_meta, d_real), True)
        gp_, _ = jl.gradient_penalty(lambda x: jd.discriminator_forward(dp, d_meta, x),
                                     d_real, d_fake, k3)
        return (lo + lr_) * 0.25 + gp_ * 0.5

    def r1_loss(dp, key):
        pen, pred = jl.r1_penalty(
            lambda x: jd.discriminator_forward(dp, d_meta, aug(x, key)), real)
        return cfg.r1_lambda / 2 * pen * cfg.d_reg_every + 0 * pred[0, 0]

    def g_loss(gp, dp, key):
        kz, ka = jax.random.split(key)
        return adv(jd.discriminator_forward(dp, d_meta, aug(synth(gp, kz), ka)), True)

    def ppl_loss(gp, key):
        _, kn = jax.random.split(key)
        noise_imgs = jax.random.normal(kn, (ppl_z.shape[0], SIZE, SIZE, 3)) / float(SIZE)
        w = jg.mapping_apply(gp, jnp.asarray(ppl_z))
        lat = jnp.repeat(w[:, None, :], n_latent, axis=1)

        def gen(l):
            return jg.generator_forward(gp, meta, [l], input_is_latent=True,
                                        randomize_noise=False, return_latents=True)[0]

        ppl, _, _ = jl.path_length_penalty(gen, lat, noise_imgs, 0.0, decay=cfg.ppl_decay)
        return cfg.ppl_lambda * cfg.g_reg_every * ppl

    return d_loss, r1_loss, g_loss, ppl_loss


def _assert_grads_close(names, ours, want_tree, kind):
    want = dict(convert._flatten(jax.tree.map(np.asarray, want_tree)))
    assert set(names) == set(want), kind
    step_max = max(float(np.abs(w).max()) for w in want.values())
    for name, g in zip(names, ours):
        w = want[name]
        tol = 1e-3 * float(np.abs(w).max()) + 1e-4 * step_max
        np.testing.assert_allclose(_np(g), w, atol=tol, rtol=0,
                                   err_msg=f"{kind}: {name}")


@pytest.mark.parametrize("kind,mixed,augment,remat", [
    pytest.param("d", True, False, "all", id="d-True-False"),
    pytest.param("d", True, False, "gp", id="d-True-False-gp"),
    pytest.param("r1", True, True, "all", id="r1-True-True"),
    pytest.param("g", False, True, "all", id="g-False-True"),
    pytest.param("ppl", True, True, "all", id="ppl-True-True")])
def test_step_gradients_match_jax(tmp_path, kind, mixed, augment, remat):
    """Each step kind's gradients from the same weights and draws as the
    JAX step's, per parameter tensor (the G tree's fixed noise maps too:
    the JAX PPL step differentiates them). R1 takes a gradient of a
    gradient through ADA and the discriminator, the G step a gradient
    through the mixed-free synthesis and ADA, the D step the WGAN-GP
    gradient of a gradient with style-mixed fakes (without ADA, whose
    forward the D step does not differentiate: tests/test_torch_ada.py
    holds it), PPL a gradient of a gradient through the synthesis. The D
    step under both ``wgangp_remat`` values: 'all' (the default)
    recomputes its two D forwards and the penalty branch in the backward,
    'gp' only the penalty branch, the gradient of a gradient through the
    checkpoint either way."""
    g_params, meta = _jax_generator()
    d_tree = disc_tree(seed=4, widths=WIDTHS)
    rng = np.random.RandomState(5)
    real = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    z = rng.randn(2, B, LAT).astype(np.float32)
    zs, inject = ([z[0], z[1]], 3) if mixed else ([z[0]], meta["n_latent"])
    ppl_z = rng.randn(B // 2, LAT).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    cfg = _cfg(tmp_path, augment=augment)

    d_loss, r1_loss, g_loss, ppl_loss = _jax_step_losses(
        meta, jd.discriminator_meta(SIZE), cfg, jnp.asarray(real),
        [jnp.asarray(a) for a in zs], inject, ppl_z)
    dp = jax.tree.map(jnp.asarray, d_tree)
    # jitted: one XLA compile costs less than eager dispatch of every op
    if kind == "d":
        loss, want = jax.jit(jax.value_and_grad(d_loss))(dp, g_params, keys[0])
    elif kind == "r1":
        loss, want = jax.jit(jax.value_and_grad(r1_loss))(dp, keys[1])
    elif kind == "g":
        loss, want = jax.jit(jax.value_and_grad(g_loss))(g_params, dp, keys[2])
    else:
        loss, want = jax.jit(jax.value_and_grad(ppl_loss))(g_params, keys[3])

    gan = _trainer(tmp_path, g_params, d_tree, augment=augment, wgangp_remat=remat)
    assert gan.wgangp_remat == remat
    gan.keep_first_grads = True
    draws = _jax_draws(keys, zs, inject, ppl_z)
    real_t = _t(real)
    if kind == "d":
        ours = gan.d_step(real_t, draws)[0]
        names = [n for n, _ in gan.netD.named_parameters()]
    elif kind == "r1":
        ours = gan.r1_step(real_t, draws)
        names = [n for n, _ in gan.netD.named_parameters()]
    elif kind == "g":
        ours = gan.g_step(draws)
        names = [n for n, _ in gan.netG.named_parameters()]
        names += [f"noises.{i}" for i in range(len(gan.netG.noises))]
    else:
        ours = gan.ppl_step(draws)[0] * cfg.ppl_lambda * cfg.g_reg_every
        names = [n for n, _ in gan.netG.named_parameters()]
        names += [f"noises.{i}" for i in range(len(gan.netG.noises))]
    np.testing.assert_allclose(float(ours), float(loss), **LOSS_TOL)
    _assert_grads_close(names, gan.first_grads[kind], want, kind)


def test_wgangp_remat_recomputes_the_d_forwards(tmp_path, monkeypatch):
    """The D forwards one D step runs: three without recomputation (fake,
    real, the penalty's interpolate); the penalty branch recomputed under
    both values, and the two adversarial forwards too under 'all'."""
    g_params, _ = _jax_generator(seed=4)
    rng = np.random.RandomState(9)
    real = _t(rng.randn(B, SIZE, SIZE, 3))
    calls = {}
    forward = tt.discriminator_forward

    def counted(*args, **kw):
        calls[remat] += 1
        return forward(*args, **kw)

    monkeypatch.setattr(tt, "discriminator_forward", counted)
    for remat in ("all", "gp"):
        calls[remat] = 0
        gan = _trainer(tmp_path, g_params, disc_tree(seed=4, widths=WIDTHS),
                       augment=False, wgangp_remat=remat)
        gan.set_input(real, iter_no=1)
        gan.d_step(gan.ref_image, gan.draws)
    assert calls["gp"] > 3, calls
    assert calls["all"] == calls["gp"] + 2, calls


def test_style_mixed_synthesis_with_noise_matches_jax():
    g_params, meta = _jax_generator(seed=1)
    rng = np.random.RandomState(7)
    z = rng.randn(2, B, LAT).astype(np.float32)
    noise = _j_noise(jax.random.PRNGKey(8))
    want_img, want_lat, want_feats = jg.generator_forward(
        g_params, meta, [jnp.asarray(z[0]), jnp.asarray(z[1])], noise=noise,
        randomize_noise=False, inject_index=3, return_latents="all")
    g = convert.from_jax_generator_params(jax.tree.map(np.asarray, g_params))
    img, lat, feats = tg.generator_forward(g, [_t(z[0]), _t(z[1])],
                                           noise=[_t(n) for n in noise],
                                           inject_index=3, return_latents="all")
    np.testing.assert_allclose(_np(lat), np.asarray(want_lat), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(img), np.asarray(want_img), atol=2e-5, rtol=1e-4)
    for a, b in zip(feats, want_feats):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5, rtol=1e-4)
    img2, lat2 = tg.generator_forward(g, [_t(z[0]), _t(z[1])],
                                      noise=[_t(n) for n in noise],
                                      inject_index=3, return_latents=True)
    assert torch.equal(img2, img) and torch.equal(lat2, lat)
    with pytest.raises(ValueError, match="inject_index"):
        tg.generator_forward(g, [_t(z[0]), _t(z[1])])
    with pytest.raises(ValueError, match="noise"):
        tg.generator_forward(g, [_t(z[0])], randomize_noise=True)


def test_make_noise_shapes_and_seed():
    meta = tg.generator_meta(SIZE, style_dim=LAT)
    a = tg.make_noise(meta, 3, torch.Generator().manual_seed(1))
    b = tg.make_noise(meta, 3, torch.Generator().manual_seed(1))
    want = [tuple(n.shape) for n in jax.eval_shape(
        lambda k: jg.make_noise(meta, k, 3), jax.random.PRNGKey(0))]
    assert [tuple(n.shape) for n in a] == want
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# losses and penalties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "bce", "wgangp"])
def test_gan_loss_matches_jax(mode):
    pred = np.random.RandomState(9).rand(6, 1).astype(np.float32) * 1.6 - 0.3
    for real in (True, False):
        np.testing.assert_allclose(float(tl.gan_loss(mode)(_t(pred), real)),
                                   float(jl.gan_loss(mode)(jnp.asarray(pred), real)),
                                   **LOSS_TOL)
    with pytest.raises(NotImplementedError):
        tl.gan_loss("hinge")


def _toy_disc(w):
    """A small nonlinear critic: sum over pixels of tanh(x @ w)."""
    def j(x):
        return jnp.sum(jnp.tanh(x @ jnp.asarray(w)), axis=(1, 2))

    def t(x):
        return torch.tanh(x @ _t(w)).sum(dim=(1, 2))

    return j, t


def test_penalties_match_jax():
    rng = np.random.RandomState(11)
    w = rng.randn(3, 1).astype(np.float32)
    real, fake = rng.randn(2, B, 5, 5, 3).astype(np.float32)
    jdisc, tdisc = _toy_disc(w)
    jr1, jpred = jl.r1_penalty(jdisc, jnp.asarray(real))
    tr1, tpred = tl.r1_penalty(tdisc, _t(real))
    np.testing.assert_allclose(float(tr1.detach()), float(jr1), **LOSS_TOL)
    np.testing.assert_allclose(_np(tpred), np.asarray(jpred), **LOSS_TOL)
    key = jax.random.PRNGKey(12)
    jgp, jgrads = jl.gradient_penalty(jdisc, jnp.asarray(real), jnp.asarray(fake), key)
    alpha = jax.random.uniform(key, (B, 1, 1, 1))
    tgp, tgrads = tl.gradient_penalty(tdisc, _t(real), _t(fake), _t(alpha))
    np.testing.assert_allclose(float(tgp.detach()), float(jgp), **LOSS_TOL)
    np.testing.assert_allclose(_np(tgrads), np.asarray(jgrads), **LOSS_TOL)
    for kind in ("real", "fake"):
        a = jl.gradient_penalty(jdisc, jnp.asarray(real), jnp.asarray(fake), key, kind=kind)[0]
        b = tl.gradient_penalty(tdisc, _t(real), _t(fake), kind=kind)[0]
        np.testing.assert_allclose(float(b), float(a), **LOSS_TOL)
    assert tl.gradient_penalty(tdisc, _t(real), _t(fake), lambda_gp=0.0) == (0.0, None)


def test_path_length_penalty_and_its_gradient_match_jax():
    rng = np.random.RandomState(13)
    wmat = (rng.randn(LAT, 2 * 4 * 4 * 3) * 0.2).astype(np.float32)
    lat = rng.randn(B, 2, LAT).astype(np.float32)
    noise = rng.randn(B, 4, 4, 3).astype(np.float32) / 4

    def jgen(l, wm):
        return jnp.tanh(l @ wm).sum(axis=1).reshape(B, 2, 4, 4, 3).sum(axis=1)

    def j_loss(wm):
        return jl.path_length_penalty(lambda l: jgen(l, wm), jnp.asarray(lat),
                                      jnp.asarray(noise), 0.5)

    jppl, jmean, jlen = j_loss(jnp.asarray(wmat))
    jgrad = jax.grad(lambda wm: j_loss(wm)[0])(jnp.asarray(wmat))
    wm = _t(wmat).requires_grad_(True)

    def tgen(l):
        return torch.tanh(l @ wm).sum(dim=1).reshape(B, 2, 4, 4, 3).sum(dim=1)

    tppl, tmean, tlen = tl.path_length_penalty(tgen, _t(lat), _t(noise), 0.5)
    (tgrad,) = torch.autograd.grad(tppl, wm)
    np.testing.assert_allclose(float(tppl), float(jppl), **LOSS_TOL)
    np.testing.assert_allclose(float(tmean), float(jmean), **LOSS_TOL)
    np.testing.assert_allclose(_np(tlen), np.asarray(jlen), **LOSS_TOL)
    np.testing.assert_allclose(_np(tgrad), np.asarray(jgrad), atol=1e-5, rtol=1e-4)
    assert not tmean.requires_grad


# ---------------------------------------------------------------------------
# optimizer, schedules, trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b1", [0.0, 0.9])
def test_adam_matches_optax(b1):
    rng = np.random.RandomState(14)
    params = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(3)]
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=0.002 * 0.8, b1=b1,
                                               b2=0.99**0.8)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [_t(p) for p in params]
    adam = tt.Adam(tp, 0.002 * 0.8, b1=b1, b2=0.99**0.8)
    for i, g in enumerate(grads):
        if i == 2:  # the lr changes between steps, as update_learning_rate does
            state.hyperparams["learning_rate"] = jnp.asarray(0.001, jnp.float32)
            adam.lr = 0.001
        upd, state = opt.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([_t(a) for a in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau"])
def test_schedulers_match_jax(policy):
    kw = dict(epoch_count=1, n_epochs=5, n_epochs_decay=4, lr_decay_iters=3)
    a, b = tt.get_scheduler(policy, **kw), jtrain.get_scheduler(policy, **kw)
    losses = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8]
    for epoch, loss in enumerate(losses):
        if policy == "plateau":
            assert a.step(loss) == pytest.approx(b.step(loss))
        else:
            assert a(epoch) == pytest.approx(b(epoch))
    with pytest.raises(NotImplementedError):
        tt.get_scheduler("exponential")


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """What the JAX trainer refuses, the port refuses (a misspelt
    ``wgangp_remat``, ``compute_dtype='float16'``); bfloat16 and the
    chunk, once refused here, now run: the bf16 trainer keeps float32
    weights, and a chunk of two plain iterations equals two single steps
    bit for bit (tests/test_torch_chunk.py and tests/test_torch_bf16.py
    hold both against the single-step path and JAX at length)."""
    with pytest.raises(NotImplementedError, match="wgangp_remat"):
        tt.BagGANHQ(_cfg(tmp_path, wgangp_remat="ALL"), device="cpu")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        tt.BagGANHQ(_cfg(tmp_path, compute_dtype="float16"), device="cpu")
    bf16 = tt.BagGANHQ(_cfg(tmp_path, compute_dtype="bfloat16"), device="cpu")
    assert bf16.compute_dtype is torch.bfloat16
    assert all(t.dtype == torch.float32 for t in bf16.g_tensors + bf16.d_tensors)
    batches = [np.random.RandomState(i).rand(B, SIZE, SIZE, 3).astype(np.float32)
               for i in range(2)]
    runs = []
    for chunked in (False, True):
        gan = tt.BagGANHQ(_cfg(tmp_path, wgangp_remat="gp", compute_dtype="float32",
                               use_ppl=False, d_reg_every=100), device="cpu")
        assert gan.compute_dtype is None
        gan.iter_no = 1
        if chunked:
            gan.optimize_parameters_chunk(batches)
        else:
            for it, b in enumerate(batches, 1):
                gan.set_input(b, iter_no=it)
                gan.optimize_parameters()
        assert gan.iter_no == 3
        runs.append(gan)
    for a, b in zip(runs[0].g_tensors + runs[0].d_tensors,
                    runs[1].g_tensors + runs[1].d_tensors):
        assert torch.equal(a, b)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.BagGANHQ(_cfg(tmp_path))


def test_five_iterations_on_the_cpu(tmp_path):
    """BagGANHQ(device='cpu') for 5 iterations from seeded draws: R1 and PPL
    at iterations 0 and 4, finite losses, ADA's controller run after each
    D step, no kernel launched,
    and checkpoints that load back in both packages."""
    g_params, _ = _jax_generator(seed=2)
    gan = _trainer(tmp_path, g_params, disc_tree(seed=3, widths=WIDTHS), ada_length=20)
    gan.ada_state["p"].fill_(P)
    _build.reset_launches()
    rng = np.random.RandomState(15)
    losses = []
    tracing.reset()
    tracing.start()
    try:
        for it in range(5):
            gan.set_input(rng.randn(B, SIZE, SIZE, 3).astype(np.float32), iter_no=it)
            gan.optimize_parameters()
            losses.append(gan.get_current_losses())
    finally:
        tracing.stop()
    spans = tracing.snapshot().spans
    tracing.reset()
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    assert [sum(s.name == tt.STEP_SPANS[k] for s in spans)
            for k in tt.STEP_KINDS] == [5, 2, 5, 2]
    assert not any(s.launches for s in spans)
    assert all(np.isfinite(list(l.values())).all() for l in losses)
    assert set(losses[0]) == {"g_gan", "d", "g_ppl"}
    assert float(gan.mean_path_length) > 0
    # the controller ran after each D step; it moves p every 8th
    assert int(gan.ada_state["update"]) == 5 and gan.ada_aug_p == pytest.approx(P)

    gan.save_networks("latest")
    for name in ("G", "D"):
        assert os.path.exists(tmp_path / "ckpt" / f"latest_net_{name}.npz")
    jtree = jser.load_pytree(str(tmp_path / "ckpt" / "latest_net_G.npz"))
    assert jax.tree.structure(jtree) == jax.tree.structure(g_params)
    ours = dict(convert._flatten(convert.module_tree(gan.netG)))
    theirs = dict(convert._flatten(jtree))
    assert ours.keys() == theirs.keys()
    for k, a in theirs.items():
        np.testing.assert_array_equal(np.asarray(a), _np(ours[k]))
    other = _trainer(tmp_path, _jax_generator(seed=9)[0], disc_tree(seed=8, widths=WIDTHS))
    other.load_networks("latest")
    for net in ("netG", "netD"):
        for a, b in zip(getattr(gan, net).state_dict().values(),
                        getattr(other, net).state_dict().values()):
            assert torch.equal(a, b)
    other.setup_gan()
    other.set_input(np.zeros((B, SIZE, SIZE, 3), np.float32), iter_no=5)
    img = other.test()
    assert img.shape == (B, SIZE, SIZE, 3) and bool(torch.isfinite(img).all())
    assert other.update_learning_rate() == pytest.approx(
        tt.get_scheduler("linear", epoch_count=1, n_epochs=2, n_epochs_decay=2)(2))
    assert other.optimizer_g.lr == pytest.approx(other._base_lrs[0] * other._lr_mult)


def test_ada_controller_tunes_p_in_the_d_step(tmp_path):
    g_params, _ = _jax_generator(seed=3)
    gan = _trainer(tmp_path, g_params, disc_tree(seed=5, widths=WIDTHS),
                   use_ppl=False, d_reg_every=100, ada_length=4)
    rng = np.random.RandomState(16)
    tracing.reset()
    try:
        for it in range(1, 9):
            if it == 8:  # iterations 1-7 record no span, the last one does
                tracing.start()
            gan.set_input(rng.randn(B, SIZE, SIZE, 3).astype(np.float32), iter_no=it)
            gan.optimize_parameters()
    finally:
        tracing.stop()
    spans = tracing.snapshot().spans
    tracing.reset()
    # one update after 8 D steps: p moves by +-(8 * B) / ada_length from 0
    assert gan.ada_aug_p in (pytest.approx(1.0), 0.0)
    assert int(gan.ada_state["update"]) == 0
    assert {s.id for s in spans} == {8}
    d_steps = [s for s in spans if s.name == "gan.d_step"]
    assert len(d_steps) == 1 and d_steps[0].launches == {}
    assert gan.draws.r1_aug is None and gan.draws.ppl_z is None


def test_draws_are_seeded(tmp_path):
    meta = tg.generator_meta(SIZE, style_dim=LAT)
    cfg = _cfg(tmp_path)
    a = tt.draw_step_inputs(torch.Generator().manual_seed(1), cfg, meta, B, 0, P)
    b = tt.draw_step_inputs(torch.Generator().manual_seed(1), cfg, meta, B, 0, P)
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) > 10
    assert all(torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
               for u, v in zip(flat_a, flat_b))
    assert a.r1_aug is not None and a.ppl_z.shape == (B // 2, LAT)
    c = tt.draw_step_inputs(torch.Generator().manual_seed(1), cfg, meta, B, 1, P)
    assert c.r1_aug is None and c.ppl_z is None
    assert 1 <= a.inject_index <= meta["n_latent"]


@pytest.mark.usefixtures("one_torch_thread")
def test_api_no_ops_change_no_flag_and_no_gradient(tmp_path):
    """``set_requires_grad`` and ``eval`` (no-ops, as in JAX, train.py:206-211)
    called between two iterations: every tensor's ``requires_grad`` stays as
    it was, and the second iteration's gradients of each step kind and the
    weights after it equal those of a run without the calls, bit for bit."""
    rng = np.random.RandomState(17)
    reals = [rng.randn(B, SIZE, SIZE, 3).astype(np.float32) for _ in range(2)]
    runs = []
    for call in (False, True):
        gan = tt.BagGANHQ(_cfg(tmp_path / str(call), d_reg_every=1, g_reg_every=1),
                          device="cpu")
        gan.set_input(reals[0], iter_no=0)
        gan.optimize_parameters()
        tensors = gan.g_tensors + gan.d_tensors
        flags = [t.requires_grad for t in tensors]
        if call:
            assert gan.set_requires_grad([gan.netD], False) is None
            assert gan.set_requires_grad([gan.netG, gan.netD], True) is None
            assert gan.eval() is None
        assert [t.requires_grad for t in tensors] == flags
        gan.keep_first_grads = True
        gan.set_input(reals[1], iter_no=1)
        gan.optimize_parameters()
        runs.append((gan.first_grads, [t.detach().clone() for t in tensors]))
    (want_grads, want_w), (got_grads, got_w) = runs
    assert set(got_grads) == set(want_grads) == {"d", "r1", "g", "ppl"}
    for kind, grads in want_grads.items():
        assert all(torch.equal(a, b) for a, b in zip(got_grads[kind], grads)), kind
    assert all(torch.equal(a, b) for a, b in zip(got_w, want_w))
