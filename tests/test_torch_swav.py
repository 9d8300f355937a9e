"""The port's SwAV pretraining (selfsup/{augmentor,embed,lars,swav}.py,
utils/serialization.py) held against the JAX package on the CPU.

Random numbers are passed in: the port's step takes one ``SwAVDraws``
record, and ``_jax_draws`` rebuilds the draws the JAX step makes from its
key by the same split sequence (swav.py:456-490, augmentor.py:31 and
141-146, swav.py:326-327).

Tolerances (float32 on both sides, sums in another order): 1e-5 absolute on
O(1) activations and losses; 1e-6 absolute plus 1e-5 relative on params of
magnitude <= 1 after LARS steps, whose size is lr * trust * |p| = 1e-4 |p|
per step (observed differences <= 6e-8).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganecdotes_tpu.models.stylegan2.generator import init_generator
from ganecdotes_tpu.selfsup import augmentor as jaug
from ganecdotes_tpu.selfsup import embed as jembed
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_tpu.utils import serialization as jser
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.ops import _build
from ganecdotes_torch.selfsup import augmentor as taug
from ganecdotes_torch.selfsup import embed as tembed
from ganecdotes_torch.selfsup import lars as tlars
from ganecdotes_torch.selfsup import swav as tswav
from ganecdotes_torch.utils import serialization as tser

ACT_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
SIZE, HLEN, NCLASSES, NPROTO, PATCH = 16, 1024, 8, 16, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_generator(seed=0):
    params, meta = init_generator(jax.random.PRNGKey(seed), SIZE)
    return params, meta, from_jax_generator_params(jax.tree.map(np.asarray, params))


def _jax_draws(key, meta, n_layers, num_patches, npix, patch, d=512):
    """The JAX step's draws from ``key``, as the port's ``SwAVDraws``."""
    k_lat, k_layer, k_vs, k_vt, k_as, k_at, k_picks = jax.random.split(key, 7)
    k_ls, k_lt = jax.random.split(k_layer)
    n = meta["n_latent"]
    a_s, f_s = jaug.random_rotate_flip_params(k_as)
    a_t, f_t = jaug.random_rotate_flip_params(k_at)
    picks = [jax.random.permutation(k, npix)[:patch]
             for k in jax.random.split(k_picks, num_patches)]
    return tswav.SwAVDraws(
        _t(jax.random.normal(k_lat, (1, d))),
        int(jax.random.randint(k_ls, (), 0, n_layers)),
        int(jax.random.randint(k_lt, (), 0, n_layers)),
        _t(jax.random.normal(k_vs, (n, d))), _t(jax.random.normal(k_vt, (n, d))),
        float(a_s), bool(f_s), float(a_t), bool(f_t),
        [_t(p).long() for p in picks])


def _pyramid(seed, b=1, sizes=((4, 8), (8, 16), (16, 12))):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, s, c).astype(np.float32) for s, c in sizes]


# ---------------------------------------------------------------------------
# augmentor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [-10.0, -3.7, 0.0, 5.2, 10.0])
@pytest.mark.parametrize("flip", [False, True])
def test_rotate_flip_matches_jax(deg, flip):
    x = np.random.RandomState(1).randn(2, 9, 12, 3).astype(np.float32)
    angle = np.float32(deg * np.pi / 180.0)
    want = jaug.rotate_flip_nhwc(jnp.asarray(x), jnp.asarray(angle),
                                 jnp.asarray(flip))
    got = taug.rotate_flip_nhwc(_t(x), float(angle), flip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_perturbed_features_match_jax_with_the_normals_passed_in():
    params, meta, gen = _jax_generator()
    rs = np.random.RandomState(2)
    w_plus = (rs.randn(1, meta["n_latent"], 512) * 0.5).astype(np.float32)
    mean = (rs.randn(1, 512) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z_rand = jax.random.normal(key, (meta["n_latent"], 512))  # what JAX draws
    for layer in (0, 1):
        row_std = jaug.block_row_std(layer, 2, (1.0, 0.5), meta["n_latent"])
        np.testing.assert_array_equal(
            taug.block_row_std(layer, 2, (1.0, 0.5), meta["n_latent"]).numpy(),
            np.asarray(row_std))
        np.testing.assert_allclose(
            taug.perturb_latents(gen, _t(w_plus), _t(z_rand),
                                 _t(row_std)).detach().numpy(),
            np.asarray(jaug.perturb_latents(params, jnp.asarray(w_plus), key,
                                            row_std)), **ACT_TOL)
        img_j, feats_j = jaug.perturbed_features(
            params, meta, jnp.asarray(w_plus), key, layer, 2, (1.0, 0.5), 0.7,
            jnp.asarray(mean))
        with torch.no_grad():
            img, feats = taug.perturbed_features(
                gen, _t(w_plus), _t(z_rand), layer, 2, (1.0, 0.5), 0.7, _t(mean))
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-4,
                                   rtol=1e-4)
        assert len(feats) == len(feats_j)
        for f, fj in zip(feats, feats_j):
            np.testing.assert_allclose(f.numpy(), np.asarray(fj), atol=1e-4,
                                       rtol=1e-4)


# ---------------------------------------------------------------------------
# embed, loss, marginals
# ---------------------------------------------------------------------------


def test_project_gathered_and_its_weight_gradient_match_jax():
    feats = _pyramid(4)
    picks = np.random.RandomState(5).randint(0, 256, 600)  # repeats included
    hlen = 30  # cuts the second level
    w = np.random.RandomState(6).randn(hlen, 9).astype(np.float32)
    fj = [jnp.asarray(f) for f in feats]
    ft = [_t(f) for f in feats]
    np.testing.assert_array_equal(
        tembed.pixel_feature_gather(ft, _t(picks), (16, 16), hlen).numpy(),
        np.asarray(jembed.pixel_feature_gather(fj, jnp.asarray(picks),
                                               (16, 16), hlen)))
    wt = _t(w).requires_grad_(True)
    got = tembed.project_gathered(ft, _t(picks), (16, 16), wt, hlen)
    want = jembed.project_gathered(fj, jnp.asarray(picks), (16, 16),
                                   jnp.asarray(w), hlen)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ACT_TOL)
    (g,) = torch.autograd.grad(got.square().sum(), wt)
    gj = jax.grad(lambda w: jnp.sum(jembed.project_gathered(
        fj, jnp.asarray(picks), (16, 16), w, hlen) ** 2))(jnp.asarray(w))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-3, rtol=1e-5)


def test_loss_prototypes_and_norm_map_match_jax():
    rs = np.random.RandomState(7)
    p_s, p_t = (rs.randn(2, 20, 11) * 3).astype(np.float32)
    q_s, q_t = rs.rand(2, 20, 11).astype(np.float32)
    np.testing.assert_allclose(
        tswav.swapped_prediction_loss(_t(p_s), _t(p_t), _t(q_s), _t(q_t)).item(),
        float(jswav.swapped_prediction_loss(*map(jnp.asarray, (p_s, p_t, q_s, q_t)))),
        **ACT_TOL)
    ssl = jax.tree.map(np.array, jswav.init_swav_params(
        jax.random.PRNGKey(8), 12, 6, 10, "linear"))
    ssl["prototype"]["weight"][:, 3] = 0.0  # the 1e-12 floor
    want = jswav.normalize_prototypes(jax.tree.map(jnp.asarray, ssl))
    got = tswav.normalize_prototypes(from_jax_params(ssl))
    np.testing.assert_allclose(got["prototype"]["weight"].numpy(),
                               np.asarray(want["prototype"]["weight"]), **ACT_TOL)
    assert got["projection"][0]["weight"] is not None
    feats = _pyramid(9)
    for hlen in (None, 20):
        np.testing.assert_allclose(
            tswav.feature_norm_map([_t(f) for f in feats], hlen).numpy(),
            np.asarray(jswav.feature_norm_map([jnp.asarray(f) for f in feats],
                                              hlen)), **ACT_TOL)


@pytest.mark.parametrize("source_pdf", ["uniform", "image"])
def test_sinkhorn_marginals_match_jax(source_pdf):
    """The 'image' pdf histograms a (1, 64, 64) norm map into K and B bins.
    The bin edges are computed as jnp computes them, so every count is
    expected to agree; 1e-6 on the pdfs allows for one value within an ulp
    of an edge landing one bin over (a shift of 1/4096 of a count's share
    would fail it, so in practice the counts are equal)."""
    vals = np.abs(np.random.RandomState(10).randn(1, 64, 64)).astype(np.float32)
    vals[0, 0, :3] = vals.max()  # ties on the closed last edge
    for shape in ((40, 24), (300, 7)):
        rj, cj = jswav.sinkhorn_marginals(shape, source_pdf, jnp.asarray(vals))
        r, c = tswav.sinkhorn_marginals(shape, source_pdf, _t(vals))
        assert r.shape == (shape[1],) and c.shape == (shape[0],)
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-6, rtol=0)
    flat = np.full((1, 4, 4), 2.5, np.float32)  # one value: jnp widens by 0.5
    np.testing.assert_allclose(tswav._histogram_pdf(_t(flat), 5).numpy(),
                               np.asarray(jswav._histogram_pdf(jnp.asarray(flat), 5)),
                               atol=1e-7)


# ---------------------------------------------------------------------------
# LARS, schedule, picks
# ---------------------------------------------------------------------------


def _sched_args(use_scheduler):
    return dict(use_scheduler=use_scheduler, train_args=dict(lr=0.01),
                warmup_epochs=2, num_epochs=5, base_lr=0.05, final_lr=0.001,
                start_warmup=0.005)


@pytest.mark.parametrize("use_scheduler", [False, True])
def test_lars_matches_optax(use_scheduler):
    """3 steps; one all-zero gradient leaf (trust ratio 1) and one all-zero
    param leaf; the lr schedule reads the optimizer's own count from 0."""
    sa = _sched_args(use_scheduler)
    rs = np.random.RandomState(11)
    params = {"a": [{"w": rs.randn(5, 3).astype(np.float32)}],
              "b": {"w": rs.randn(4).astype(np.float32),
                    "z": np.zeros(3, np.float32)}}
    jsched = jswav.make_lr_schedule(sa, num_samples=1)
    opt = optax.lars(learning_rate=jsched, momentum=0.9, trust_coefficient=0.01)
    topt = tlars.LARS(tswav.make_lr_schedule(sa, num_samples=1), momentum=0.9,
                      trust_coefficient=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_params(params)
    js, ts = opt.init(jp), topt.init(tp)
    for i in range(3):
        g = {"a": [{"w": rs.randn(5, 3).astype(np.float32)}],
             "b": {"w": np.zeros(4, np.float32) if i == 1 else
                   rs.randn(4).astype(np.float32),
                   "z": rs.randn(3).astype(np.float32)}}
        ju, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(from_jax_params(g), ts, tp)
        tp = tlars.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(jp), tlars.tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7,
                                       rtol=1e-6, err_msg=f"step {i}")
    assert ts.count == 3


def test_lr_schedule_matches_jax():
    for use in (False, True):
        sa = _sched_args(use)
        js, ts = jswav.make_lr_schedule(sa, 1), tswav.make_lr_schedule(sa, 1)
        for step in range(7):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_pick_fn_branches():
    g = torch.Generator().manual_seed(0)
    picks = tswav.make_pick_fn("random", 16, 16, 40)(g)
    assert picks.shape == (40,) and len(set(picks.tolist())) == 40
    assert 0 <= int(picks.min()) and int(picks.max()) < 256
    block = tswav.make_pick_fn("patch", 16, 16, 5)(g)
    p = int(block[0]) // 17  # the block starts at (p, p)
    assert 0 <= p < 16 - 5
    jblock = jswav.make_pick_fn("patch", 16, 16, 5)(jax.random.PRNGKey(1))
    pj = int(jblock[0]) // 17
    np.testing.assert_array_equal(block.numpy() - (p - pj) * 17, np.asarray(jblock))
    np.testing.assert_array_equal(
        tswav.make_pick_fn("patch", 16, 16, 16)(g).numpy(), np.arange(256))


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def _step_configs(eps, temperature, source_pdf, num_patches=2):
    mc = {"truncation": 0.7, "latent_dim": 512}
    pa = dict(truncation=0.7, n_layers=2, n_samples=1, layer_no=None,
              perturb_std=[1.0, 1.0])
    sa = dict(num_epochs=1, num_samples=1, num_patches=num_patches,
              patch_size=PATCH, hf_interp="nearest", warmup_epochs=1,
              start_warmup=0.01, use_scheduler=False, base_lr=0.01,
              final_lr=0.0001, trust_coeff=0.01,
              train_args=dict(lr=0.01, momentum=0.9), projn_nw="linear",
              temperature=temperature, nprototypes=NPROTO, nclasses=NCLASSES,
              hlen=HLEN, add_local_loss=False)
    sk = dict(source_pdf=source_pdf, niters=3, eps=eps)
    return mc, pa, sa, sk


@pytest.mark.parametrize("eps,temperature,source_pdf", [
    (0.05, 0.1, "uniform"), (0.005, 0.01, "uniform"), (0.05, 0.1, "image")])
def test_swav_step_matches_jax(eps, temperature, source_pdf):
    """Two steps of make_swav_train_step from equal params and equal draws:
    the loss of each step and every leaf after the second."""
    params, meta, gen = _jax_generator()
    k_ssl, k1, k2 = jax.random.split(jax.random.PRNGKey(12), 3)
    ssl = jswav.init_swav_params(k_ssl, HLEN, NCLASSES, NPROTO, "linear")
    mean = (np.random.RandomState(13).randn(1, 512) * 0.3).astype(np.float32)
    mc, pa, sa, sk = _step_configs(eps, temperature, source_pdf)
    opt, step = jswav.make_swav_train_step(meta, mc, pa, sa, sk,
                                           jnp.asarray(mean), (SIZE, SIZE))
    topt, tstep = tswav.make_swav_train_step(gen.meta, mc, pa, sa, sk, _t(mean),
                                             (SIZE, SIZE))
    jp, js = ssl, opt.init(ssl)
    tp = from_jax_params(jax.tree.map(np.asarray, ssl))
    ts = topt.init(tp)
    for it, key in enumerate((k1, k2)):
        jp, js, jl = step(params, jp, js, key, it)
        draws = _jax_draws(key, meta, 2, sa["num_patches"], SIZE * SIZE, PATCH)
        tp, ts, tl = tstep(gen, tp, ts, draws, it)
        np.testing.assert_allclose(tl.item(), float(jl), **ACT_TOL)
    for a, b in zip(jax.tree.leaves(jp), tlars.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL)
    j_trace = [a for a in jax.tree.leaves(js) if np.ndim(a)]  # not the count
    t_trace = tlars.tree_leaves(ts.trace)
    assert len(j_trace) == len(t_trace)
    for a, b in zip(j_trace, t_trace):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL)


# ---------------------------------------------------------------------------
# checkpoints and SwAVClustering
# ---------------------------------------------------------------------------


def test_swav_params_npz_round_trips_between_the_packages(tmp_path):
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(14), 12, 6, 10, "2-layer"))
    tree = dict(ssl, extra=(np.arange(3, dtype=np.int32),
                            jnp.asarray([1.5, -2.0], jnp.bfloat16)))
    jser.save_pytree(str(tmp_path / "from_jax.npz"), tree)
    got = tser.load_pytree(str(tmp_path / "from_jax.npz"))
    assert isinstance(got["extra"], tuple) and len(got["projection"]) == 4
    assert got["extra"][1].dtype == torch.bfloat16
    assert got["extra"][1].float().tolist() == [1.5, -2.0]
    for a, b in zip(jax.tree.leaves(ssl), tlars.tree_leaves(
            {k: got[k] for k in ssl})):
        np.testing.assert_array_equal(b.numpy(), a)
    ours = dict(from_jax_params(ssl), extra=(torch.arange(3, dtype=torch.int32),
                                             torch.tensor([1.5, -2.0]).bfloat16()))
    tser.save_pytree(str(tmp_path / "from_torch.npz"), ours)
    back = jser.load_pytree(str(tmp_path / "from_torch.npz"))
    assert back["extra"][1].dtype == jnp.bfloat16
    assert back["extra"][0].tolist() == [0, 1, 2]
    for a, b in zip(jax.tree.leaves({k: back[k] for k in ssl}),
                    jax.tree.leaves(ssl)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _clustering_args(tmp_path, **swav_over):
    mc = SimpleNamespace(truncation=0.7, latent_dim=512, image_size=SIZE,
                         num_latents_for_mean=64)
    pa = dict(truncation=0.7, n_layers=2, n_samples=1, layer_no=None,
              perturb_std=[1.0, 1.0])
    _, _, sa, sk = _step_configs(0.05, 0.1, "uniform", num_patches=1)
    sa.update(num_epochs=2, epoch_print_freq=1, **swav_over)
    return mc, pa, sa, sk


def test_swav_clustering_pretrains_saves_loads_and_predicts(tmp_path):
    _, _, gen = _jax_generator()
    mc, pa, sa, sk = _clustering_args(tmp_path)
    logs = []
    logger = SimpleNamespace(info=logs.append)
    _build.reset_launches()
    swav = tswav.SwAVClustering(gen, mc, pa, sa, sk, logger=logger,
                                out_dir=str(tmp_path), device="cpu", seed=3)
    swav.record_loss_history = True
    swav.preprocess(None)
    assert swav.pretrain_count == 1 and len(swav.loss_history) == 2
    assert np.isfinite(swav.loss_history).all()
    assert len(logs) == 3 and "Loss" in logs[0]
    assert os.path.exists(os.path.join(tmp_path, "swav_params.npz"))
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    # a second run from the same seed takes the same steps
    again = tswav.SwAVClustering(gen, mc, pa, sa, sk, device="cpu", seed=3)
    again.pretrain()
    for a, b in zip(tlars.tree_leaves(swav.ssl_params),
                    tlars.tree_leaves(again.ssl_params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # train=False loads the saved params instead of pretraining
    loaded = tswav.SwAVClustering(gen, mc, pa, sa, sk, train=False,
                                  out_dir=str(tmp_path), device="cpu", seed=3)
    loaded.preprocess(None)
    assert loaded.pretrain_count == 0
    for a, b in zip(tlars.tree_leaves(swav.ssl_params),
                    tlars.tree_leaves(loaded.ssl_params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    preds, labels = loaded.predict_swav_codes(
        np.random.RandomState(0).randn(512).astype(np.float32),
        input_is_latent=False)
    assert preds.shape == (1, SIZE, SIZE, NCLASSES)
    assert labels.shape == (1, SIZE, SIZE) and int(labels.max()) < NCLASSES


@pytest.mark.parametrize("option", [dict(add_local_loss=True),
                                    dict(checkpoint_every=1),
                                    dict(plot_test_images=True)])
def test_swav_clustering_refuses_unported_options(tmp_path, option):
    """Each option, which raised before it was ported, now runs its
    pretraining (tests/test_torch_swav_options.py holds each against the
    JAX package): the local loss trains to finite params, a run with
    snapshots leaves none behind, and the plots are written each epoch."""
    import matplotlib

    matplotlib.use("Agg")
    _, _, gen = _jax_generator()
    mc, pa, sa, sk = _clustering_args(tmp_path, **option)
    swav = tswav.SwAVClustering(gen, mc, pa, sa, sk, out_dir=str(tmp_path),
                                device="cpu")
    swav.record_loss_history = True
    swav.pretrain()
    assert len(swav.loss_history) == 2 and np.isfinite(swav.loss_history).all()
    assert all(torch.isfinite(t).all() for t in tlars.tree_leaves(swav.ssl_params))
    assert not os.path.exists(tmp_path / "swav_pretrain_state.npz")
    plots = sorted(os.listdir(tmp_path / "swav"))
    assert plots == (["test_epoch_0.png", "test_epoch_1.png"]
                     if "plot_test_images" in option else [])


def test_swav_clustering_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                               tmp_path):
    _, _, gen = _jax_generator()
    mc, pa, sa, sk = _clustering_args(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tswav.SwAVClustering(gen, mc, pa, sa, sk)
    with pytest.raises(RuntimeError, match="CUDA"):
        tswav.SwAVClustering(gen, mc, pa, sa, sk, device="cuda")
