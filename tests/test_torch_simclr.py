"""The port's SimCLR (selfsup/simclr.py) held against the JAX package on the
CPU.

Random numbers are passed in: the port's step takes one ``SimCLRDraws``
record, and ``_jax_draws`` rebuilds the draws the JAX step makes from its
key by the same split sequence (simclr.py:153-171, augmentor.py:31 and
140-146).

Tolerances (float32 on both sides, sums in another order): 1e-5 absolute
plus relative on O(1) scores and losses; params after LARS steps 1e-6
absolute plus 1e-5 relative (a step moves a leaf by lr * trust * |p|);
the folded segment against the per-image form 2e-4 absolute
(tests/test_selfsup.py:930's tolerance for the same identity).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.stylegan2.generator import init_generator
from ganecdotes_tpu.selfsup import augmentor as jaug
from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.selfsup import simclr as jsim
from ganecdotes_tpu.utils import serialization as jser
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.selfsup import heads as theads
from ganecdotes_torch.selfsup import lars as tlars
from ganecdotes_torch.selfsup import simclr as tsim

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
SIZE, HLEN, NCLASSES, BATCH = 16, 1024, 8, 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ssl(seed=0, hlen=HLEN, ncls=NCLASSES):
    """JAX SimCLR params with the BN's gamma and beta moved off 1 and 0."""
    p = _np(jsim.init_simclr_params(jax.random.PRNGKey(seed), hlen, ncls))
    rs = np.random.RandomState(seed)
    p["bn"]["gamma"] = (rs.rand(ncls) + 0.5).astype(np.float32)
    p["bn"]["beta"] = (rs.randn(ncls) * 0.1).astype(np.float32)
    return p


def _jax_draws(key, meta, n_layers, npix, batch, d=512):
    """The JAX step's draws from ``key``, as the port's ``SimCLRDraws``."""
    k_lat, k_layer, k_vs, k_vt, k_as, k_at, k_pick = jax.random.split(key, 7)
    k_ls, k_lt = jax.random.split(k_layer)
    n = meta["n_latent"]
    a_s, f_s = jaug.random_rotate_flip_params(k_as)
    a_t, f_t = jaug.random_rotate_flip_params(k_at)
    return tsim.SimCLRDraws(
        _t(jax.random.normal(k_lat, (1, d))),
        int(jax.random.randint(k_ls, (), 0, n_layers)),
        int(jax.random.randint(k_lt, (), 0, n_layers)),
        _t(jax.random.normal(k_vs, (n, d))), _t(jax.random.normal(k_vt, (n, d))),
        float(a_s), bool(f_s), float(a_t), bool(f_t),
        _t(jax.random.permutation(k_pick, npix)[:batch]).long())


def test_init_shapes_and_bounds():
    p = tsim.init_simclr_params(40, 6, torch.Generator().manual_seed(0))
    j = jsim.init_simclr_params(jax.random.PRNGKey(0), 40, 6)
    assert jax.tree.structure(_np(j)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), p))
    assert p["lin1"]["weight"].abs().max() <= 40 ** -0.5
    assert p["lin2"]["weight"].abs().max() <= 6 ** -0.5


def test_projection_and_nt_xent_match_jax():
    ssl = _ssl()
    rs = np.random.RandomState(1)
    z = rs.randn(10, NCLASSES).astype(np.float32)
    want = jsim.simclr_projection(jax.tree.map(jnp.asarray, ssl), jnp.asarray(z))
    got = tsim.simclr_projection(from_jax_params(ssl), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    s, t = rs.randn(2, 9, NCLASSES).astype(np.float32)
    for temp in (1.0, 0.1):
        jl, jg = jax.value_and_grad(jsim.nt_xent_loss, argnums=(0, 1))(
            jnp.asarray(s), jnp.asarray(t), temp)
        ts, tt = _t(s).requires_grad_(True), _t(t).requires_grad_(True)
        loss = tsim.nt_xent_loss(ts, tt, temp)
        gs, gt = torch.autograd.grad(loss, (ts, tt))
        np.testing.assert_allclose(loss.item(), float(jl), **TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(jg[0]), **TOL)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jg[1]), **TOL)


def test_simclr_steps_match_jax():
    """Two steps of make_simclr_train_step from equal params and equal
    draws: each step's loss, then every leaf and the LARS trace."""
    params, meta = init_generator(jax.random.PRNGKey(0), SIZE)
    gen = from_jax_generator_params(_np(params))
    ssl = _ssl(2)
    mean = (np.random.RandomState(3).randn(1, 512) * 0.3).astype(np.float32)
    pa = dict(truncation=0.7, n_layers=2, n_samples=1, layer_no=None,
              perturb_std=[1.0, 1.0])
    sa = dict(num_iters=2, batch_size=BATCH, patch_size=64, hf_interp="nearest",
              trust_coeff=0.01, train_args=dict(lr=0.1, momentum=0.9),
              temperature=0.5, nclasses=NCLASSES, hlen=HLEN)
    mc = {"truncation": 0.7, "latent_dim": 512}
    opt, step = jsim.make_simclr_train_step(meta, mc, pa, sa, jnp.asarray(mean),
                                            (SIZE, SIZE))
    topt, tstep = tsim.make_simclr_train_step(gen.meta, mc, pa, sa, _t(mean),
                                              (SIZE, SIZE))
    jp = jax.tree.map(jnp.asarray, ssl)
    js = opt.init(jp)
    tp = from_jax_params(ssl)
    ts = topt.init(tp)
    for key in jax.random.split(jax.random.PRNGKey(4), 2):
        jp, js, jl = step(params, jp, js, key)
        draws = _jax_draws(key, meta, 2, SIZE * SIZE, BATCH)
        tp, ts, tl = tstep(gen, tp, ts, draws)
        np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    for a, b in zip(jax.tree.leaves(jp), tlars.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL)
    j_trace = [a for a in jax.tree.leaves(js) if np.ndim(a)]
    t_trace = tlars.tree_leaves(ts.trace)
    assert len(j_trace) == len(t_trace)
    for a, b in zip(j_trace, t_trace):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL)


@pytest.mark.parametrize("size", ["XS", "Lin"])
def test_fold_linear_into_head_matches_jax(size):
    seg = _np(jheads.init_one_shot_segmentor(jax.random.PRNGKey(3), 24, 6, size))
    lin = (np.random.RandomState(4).randn(24, 24) * 0.3).astype(np.float32)
    x = np.random.RandomState(5).randn(2, 9, 9, 24).astype(np.float32)
    tseg = from_jax_params(seg)
    want = theads.one_shot_segmentor_apply(tseg, _t(x) @ _t(lin), size)
    got = theads.one_shot_segmentor_apply(
        tsim.fold_linear_into_head(tseg, _t(lin)), _t(x), size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    jfold = jsim.fold_linear_into_head(jax.tree.map(jnp.asarray, seg),
                                       jnp.asarray(lin))
    for a, b in zip(jax.tree.leaves(jfold),
                    tlars.tree_leaves(tsim.fold_linear_into_head(tseg, _t(lin)))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_predict_segment_matches_the_per_image_form_and_jax():
    """The folded segment (per-image one-pass BN stats, lin2 folded) against
    the per-image unfused form, and both against the JAX functions."""
    hlen, ncls = 96, 16
    ssl = _ssl(5, hlen, ncls)
    seg = _np(jheads.init_one_shot_segmentor(jax.random.PRNGKey(1), ncls, 5, "XS"))
    rs = np.random.RandomState(6)
    feats = [rs.randn(3, r, r, c).astype(np.float32)
             for r, c in [(4, 32), (8, 32), (8, 32)]]
    tssl, tseg = from_jax_params(ssl), from_jax_params(seg)
    tf = [_t(f) for f in feats]
    got = tsim.simclr_predict_segment(tssl, tf, tseg, "XS", hlen)
    embs = [tsim.simclr_predict_from_features(tssl, [f[i : i + 1] for f in tf], hlen)
            for i in range(3)]
    want = torch.cat([theads.one_shot_segmentor_apply(tseg, e, "XS") for e in embs])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    jf = [jnp.asarray(f) for f in feats]
    jgot = jsim.simclr_predict_segment(jax.tree.map(jnp.asarray, ssl), jf,
                                       jax.tree.map(jnp.asarray, seg), "XS", hlen)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4, rtol=1e-4)
    jemb = jsim.simclr_predict_from_features(jax.tree.map(jnp.asarray, ssl),
                                             [f[:1] for f in jf], hlen)
    np.testing.assert_allclose(embs[0].numpy(), np.asarray(jemb), **TOL)


class _MC:
    truncation = 0.7
    latent_dim = 512
    image_size = SIZE
    num_latents_for_mean = 8


def _clustering(tmp_path, train=True, **kw):
    params, _ = init_generator(jax.random.PRNGKey(0), SIZE)
    gen = from_jax_generator_params(_np(params))
    return tsim.SimCLRClustering(
        model=gen, model_config=_MC(),
        perturb_args=dict(truncation=0.7, n_layers=2, n_samples=1,
                          layer_no=None, perturb_std=[1.0, 1.0]),
        simclr_args=dict(num_iters=3, batch_size=BATCH, patch_size=64,
                         hf_interp="nearest", trust_coeff=0.01,
                         train_args=dict(lr=0.1, momentum=0.9), temperature=1.0,
                         nclasses=NCLASSES, hlen=HLEN, epoch_print_freq=100),
        out_dir=str(tmp_path), train=train, **kw)


def test_simclr_clustering_pretrains_saves_loads_and_predicts(tmp_path):
    sim = _clustering(tmp_path, device="cpu", seed=3)
    sim.record_loss_history = True
    sim.preprocess(None)
    assert sim.pretrain_count == 1 and len(sim.loss_history) == 3
    assert np.isfinite(sim.loss_history).all() and len(sim.step_seconds) == 3
    path = os.path.join(str(tmp_path), "simclr_params.npz")
    # the JAX package reads the file the port wrote
    for a, b in zip(jax.tree.leaves(jser.load_pytree(path)),
                    tlars.tree_leaves(sim.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    again = _clustering(tmp_path, train=False, device="cpu", seed=3)
    again.preprocess(None)  # loads, never pretrains
    assert again.pretrain_count == 0
    w = np.random.RandomState(0).randn(512).astype(np.float32)
    s1, l1 = sim.predict_simclr_codes(w)
    s2, l2 = again.predict_simclr_codes(w)
    assert s1.shape == (1, SIZE, SIZE, NCLASSES) and l1.shape == (1, SIZE, SIZE)
    torch.testing.assert_close(s1, s2)


def test_simclr_clustering_raises_for_projection_pt_and_without_a_card(
        tmp_path, monkeypatch):
    open(os.path.join(str(tmp_path), "projection.pt"), "wb").close()
    with pytest.raises(NotImplementedError, match="item 5"):
        _clustering(tmp_path, train=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _clustering(tmp_path)
