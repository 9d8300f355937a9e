"""The port's k-means (selfsup/kmeans.py: flat and hierarchical, the flat
and the belief encodings) held against the JAX package on the CPU.

The port cannot reproduce ``jax.random``'s draws, so they are passed in:
the k-means++ seeding takes the JAX run's first index and uniforms (rebuilt
from its key by ``_kmeans_single``'s split sequence, kmeans.py:71-86, and
``jax.random.choice``'s inverse CDF at 1 - uniform), Lloyd's iterations and
``kmeans_fit(init_centers=...)`` start from given centers, and the
preprocessor's fit takes the JAX run's perturbation normals and the belief
samples' latents. A fit of many seedings (``n_init`` runs a layer) replays
them all: ``_record_fits`` records the JAX run's ``kmeans_fit`` calls, whose
key gives each run's picks.

Tolerances (float32 on both sides, sums in another order): centers and
inertias 1e-4 absolute plus relative after Lloyd's iterations on O(1) data
(assignments equal); labels equal; logits 1e-4 absolute plus relative
(2e-4 for the folded forms, tests/test_selfsup.py:1080's tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.stylegan2.generator import Generator as JaxGenerator
from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.selfsup import kmeans as jkm
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.selfsup import heads as theads
from ganecdotes_torch.selfsup import kmeans as tkm

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(n=300, d=6, k=4, seed=0):
    rs = np.random.RandomState(seed)
    means = rs.randn(k, d) * 3
    return (means[rs.randint(0, k, n)] + rs.randn(n, d)).astype(np.float32)


def _jax_seeding(x, key, k):
    """The picks and the draws of ``jkm._kmeans_single``'s k-means++ loop,
    replayed eagerly with its own key splits and ``jax.random.choice``."""
    n = x.shape[0]
    key, k0 = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, n))
    picks, us = [first], []
    for _ in range(1, k):
        key, kc = jax.random.split(key)
        c = x[np.array(picks)]
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1).min(axis=1)
        probs = d2 / max(d2.sum(), 1e-12)
        picks.append(int(jax.random.choice(kc, n, p=jnp.asarray(probs))))
        us.append(1.0 - float(jax.random.uniform(kc, (), dtype=jnp.float32)))
    return picks, (first, np.asarray(us, np.float32))


def test_lloyd_refine_and_init_centers_fit_match_jax():
    x = _blobs()
    init = x[[0, 50, 100, 150]] + 0.1
    jc, ja, ji = jkm._lloyd_refine(jnp.asarray(x), jnp.asarray(init), max_iter=8)
    tc, ta, ti = tkm._lloyd_refine(_t(x), _t(init), max_iter=8)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(ti.item(), float(ji), **TOL)
    # an empty cluster keeps its center
    far = np.concatenate([init, np.full((1, 6), 1e3, np.float32)])
    tc, _, _ = tkm._lloyd_refine(_t(x), _t(far), max_iter=3)
    np.testing.assert_array_equal(tc[-1].numpy(), far[-1])
    got = tkm.kmeans_fit(_t(x), 3, init_centers=_t(init), max_iter=5)
    want = jkm.kmeans_fit(x, 3, jax.random.PRNGKey(0), init_centers=init,
                          max_iter=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_kmeans_single_run_matches_jax_with_its_draws(seed):
    """k-means++ with the JAX run's draws picks the JAX run's points (the
    same distances to the nearest chosen center, the same inverse CDF), and
    Lloyd's iterations from them give ``_kmeans_single``'s centers."""
    x = _blobs(seed=seed)
    key = jax.random.PRNGKey(seed)
    picks, draws = _jax_seeding(x, key, 5)
    centers, idx = tkm.kmeans_pp_init(_t(x), 5, draws=draws)
    assert idx.tolist() == picks
    np.testing.assert_array_equal(centers.numpy(), x[picks])
    jc, _, ji = jkm._kmeans_single(jnp.asarray(x), key, 5, max_iter=10)
    tc, _, ti = tkm._lloyd_refine(_t(x), centers, max_iter=10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ti.item(), float(ji), **TOL)
    # replaying the picks draws nothing and gives the same centers
    again, idx2 = tkm.kmeans_pp_init(_t(x), 5, indices=idx)
    assert torch.equal(again, centers) and torch.equal(idx2, idx)


def test_seeding_picks_one_point_per_separated_cluster():
    """The seeding's distribution: with k tight clusters far apart, each
    pick after the first lands in a cluster not chosen yet (probability
    1 - O(1e-8) per pick), whatever the seed."""
    rs = np.random.RandomState(3)
    x = np.concatenate([c + rs.randn(40, 3) * 1e-3
                        for c in np.eye(3) * 100]).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        _, idx = tkm.kmeans_pp_init(_t(x), 3, generator=g)
        assert sorted(int(i) // 40 for i in idx) == [0, 1, 2]
    centers, seeds = tkm.kmeans_fit_seeded(_t(x), 3, g, n_init=2, max_iter=3)
    assert len(seeds) == 2
    np.testing.assert_allclose(np.sort(centers.numpy().max(axis=1)), [100] * 3,
                               atol=1e-2)


def test_predict_parts_and_resize_labels_match_jax():
    rs = np.random.RandomState(7)
    x1 = rs.randn(300, 6).astype(np.float32)
    x2 = rs.randn(300, 5).astype(np.float32)
    c = rs.randn(4, 11).astype(np.float32)
    want = np.asarray(jkm.kmeans_predict(jnp.concatenate([x1, x2], -1), c))
    np.testing.assert_array_equal(
        tkm.kmeans_predict_parts([_t(x1), _t(x2)], _t(c)).numpy(), want)
    np.testing.assert_array_equal(
        tkm.kmeans_predict(torch.cat([_t(x1), _t(x2)], -1), _t(c)).numpy(), want)
    with pytest.raises(ValueError):
        tkm.kmeans_predict_parts([_t(x1)], _t(c))
    for h, w, out in [(4, 4, 256), (8, 8, 16), (5, 5, 16), (16, 16, 16), (3, 6, 12)]:
        lab = rs.randint(0, 7, size=(2, h, w))
        got = tkm._resize_labels(_t(lab), out)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jkm._resize_labels(jnp.asarray(lab), out)))
        assert got.dtype == torch.int64


def _groups(rs, b=2):
    return [rs.randn(b, 4, 4, 6).astype(np.float32),
            rs.randn(b, 8, 8, 5).astype(np.float32),
            rs.randn(b, 16, 16, 4).astype(np.float32)]


@pytest.mark.parametrize("cpl,size,out_size", [
    ([3, 5, 7], "S", 32),     # narrow: the multi-hot concat
    ([3, 5, 7], "XS", 64),    # 15 <= 2 * 16: narrow, out_size above the maps
    ([9, 9, 9], "XXS", 32),   # 27 > 2 * 12: the concat_segment_fcn branch
    ([3, 5, 7], "Lin", 32),   # the Lin head through concat_segment_fcn
])
def test_hfc_segment_fcn_matches_unfused_and_jax(cpl, size, out_size):
    rs = np.random.RandomState(0)
    groups = _groups(rs)
    centers = [rs.randn(k, g.shape[-1]).astype(np.float32)
               for k, g in zip(cpl, groups)]
    seg = jax.tree.map(np.asarray, jheads.init_one_shot_segmentor(
        jax.random.PRNGKey(1), sum(cpl), 4, size))
    tg, tc, tseg = [_t(g) for g in groups], [_t(c) for c in centers], from_jax_params(seg)
    z, labels = tkm.hfc_predict_from_features(tg, tc, cpl, out_size,
                                              hier_encode=False)
    jz, jlabels = jkm.hfc_predict_from_features(
        [jnp.asarray(g) for g in groups], [jnp.asarray(c) for c in centers], cpl,
        out_size, hier_encode=False)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    for a, b in zip(labels, jlabels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = theads.one_shot_segmentor_apply(tseg, z, size)
    got, glabels = tkm.hfc_segment_fcn(tg, tc, cpl, out_size, tseg, size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)
    for a, b in zip(glabels, labels):
        assert torch.equal(a, b)
    if size != "Lin":  # the JAX form has no Lin branch
        jgot, _ = jkm.hfc_segment_fcn(
            [jnp.asarray(g) for g in groups], [jnp.asarray(c) for c in centers],
            cpl, out_size, jax.tree.map(jnp.asarray, seg), size)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-4,
                                   rtol=2e-4)
    # channel parts (group_features_by_block(concat=False)) give the same
    parts = [(g[..., :2], g[..., 2:]) for g in tg]
    pgot, _ = tkm.hfc_segment_fcn(parts, tc, cpl, out_size, tseg, size)
    np.testing.assert_allclose(pgot.numpy(), got.numpy(), atol=1e-5, rtol=1e-5)
    # the belief encoding of the same input, beliefs estimated from it
    hz, hlabels = tkm.hfc_predict_from_features(tg, tc, cpl, out_size,
                                                hier_encode=True)
    jhz, jhlabels = jkm.hfc_predict_from_features(
        [jnp.asarray(g) for g in groups], [jnp.asarray(c) for c in centers], cpl,
        out_size, hier_encode=True)
    np.testing.assert_array_equal(hz.numpy(), np.asarray(jhz))
    for a, b in zip(hlabels, jhlabels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _MC:
    truncation = 0.7
    latent_dim = 512
    image_size = 16
    num_latents_for_mean = 8


def _prep_args(out_dir, presaved=False, **kmeans_args):
    return dict(
        perturb_args=dict(truncation=0.7, n_layers=2, n_samples=2,
                          perturb_std=[1.0, 1.0]),
        hfc_algo="hfc_kmeans",
        hfc_args=dict(kmeans_args=dict(verbose=0, **kmeans_args),
                      base_args=dict(out_dir=None, n_layers=2,
                                     clusters_per_layer=[3, 4], out_size=16,
                                     presaved=presaved)),
        hier_encode=False, hle_samples=2, train=True, out_dir=out_dir)


def test_preprocessor_fit_features_and_checkpoints_match_jax(tmp_path):
    """The fit's perturbed features with the JAX run's normals, the flat
    checkpoints in the JAX layout both ways, and the one-shot features."""
    jgen = JaxGenerator(size=16, key=jax.random.PRNGKey(0))
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jgen.params))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpre = jkm.HFCPreprocessor(jgen, _MC(), **_prep_args(jdir))
    tpre = tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                               **_prep_args(tdir, n_init=2, max_iter=10))
    tpre.mean_latent = _t(jpre.mean_latent)
    w = (np.random.RandomState(1).randn(1, 512) * 0.5).astype(np.float32)

    # the JAX fit's perturbation normals: its key after the mean latent's split
    key = jax.random.split(jax.random.PRNGKey(42))[0]
    z_rands = []
    for _ in range(2):
        key, kp = jax.random.split(key)
        z_rands.append(_t(jax.random.normal(kp, (2 * jgen.meta["n_latent"], 512))))
    jhidden = jpre.train_hfc_model(w, return_aug=True)
    thidden = tpre.train_hfc_model(w, z_rands=z_rands)
    for a, b in zip(thidden, jhidden):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    names = sorted(os.listdir(tdir))
    assert {"clusterer_layer_0.npz", "clusterer_layer_1.npz",
            "model_stats.npz"} <= set(names)
    for n in range(2):  # Lloyd's from the JAX centers over the port's features
        refit = tkm.kmeans_fit(thidden[n].reshape(-1, thidden[n].shape[-1]),
                               [3, 4][n], init_centers=_t(jpre.hfc_model.centers[n]),
                               max_iter=10)
        want = jkm.kmeans_fit(jhidden[n].reshape(-1, jhidden[n].shape[-1]), [3, 4][n],
                              jax.random.PRNGKey(0),
                              init_centers=jpre.hfc_model.centers[n], max_iter=10)
        np.testing.assert_allclose(refit.numpy(), np.asarray(want), **TOL)
    stats = np.load(os.path.join(tdir, "model_stats.npz"), allow_pickle=True)
    np.testing.assert_allclose(stats["means"][1],
                               thidden[1].flatten(0, 2).mean(0).numpy(), **TOL)

    # each package loads the other's clusterers (presaved), same features
    jload = jkm.HFCPreprocessor(jgen, _MC(), **dict(_prep_args(tdir, True),
                                                    train=False))
    tload = tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                                **dict(_prep_args(jdir, True), train=False))
    tload.mean_latent = _t(jload.mean_latent)
    jz, _ = jload.predict_hfc_vectors(w)
    tz, _ = tload.predict_hfc_vectors(w)
    for a, b in zip(jload.hfc_model.centers, tpre.hfc_model.centers):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jpre.mean_latent = jload.mean_latent
    jz2, _ = jpre.predict_hfc_vectors(w)  # the JAX centers, read by the port
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz2))
    assert jz.shape == tz.shape == (1, 16, 16, 7)


def _record_fits(monkeypatch):
    """Record the JAX package's ``kmeans_fit`` calls: (x, k, key) of each
    seeded fit, None for a fit from given centers."""
    calls, fit = [], jkm.kmeans_fit

    def recording(x, k, key, *args, init_centers=None, **kw):
        calls.append(None if init_centers is not None
                     else (np.asarray(x), k, key))
        return fit(x, k, key, *args, init_centers=init_centers, **kw)

    monkeypatch.setattr(jkm, "kmeans_fit", recording)
    return calls


def _replay(call, n_init=10):
    """The k-means++ picks of each of a recorded fit's ``n_init`` runs."""
    x, k, key = call
    return [torch.tensor(_jax_seeding(x, jax.random.fold_in(key, i), k)[0])
            for i in range(n_init)]


def _fit_both(tmp_path, monkeypatch, **over):
    """The JAX and the port's preprocessors fitted on one 16^2 generator,
    the port replaying the JAX run's perturbation normals, seedings and
    belief samples' latents; -> (JAX's, the port's, the sample's w, the
    JAX block features)."""
    jgen = JaxGenerator(size=16, key=jax.random.PRNGKey(0))
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jgen.params))
    args = {k: dict(_prep_args(str(tmp_path / k)), **over) for k in ("jax", "torch")}
    jpre = jkm.HFCPreprocessor(jgen, _MC(), **args["jax"])
    tpre = tkm.HFCPreprocessor(gen, _MC(), device="cpu", **args["torch"])
    tpre.mean_latent = _t(jpre.mean_latent)
    w = (np.random.RandomState(1).randn(1, 512) * 0.5).astype(np.float32)
    key, z_rands = jpre.key, []
    for _ in range(2):
        key, kp = jax.random.split(key)
        z_rands.append(_t(jax.random.normal(kp, (2 * jgen.meta["n_latent"], 512))))
    hle_zs = []
    for _ in range(2):
        key, kz = jax.random.split(key)
        hle_zs.append(_t(jax.random.normal(kz, (1, 512))))
    calls = _record_fits(monkeypatch)
    jhidden = jpre.train_hfc_model(w, return_aug=True)
    hier = over.get("hfc_algo") == "hfc_kmeans_hier"
    order = [0] if hier else [0, 1]
    seeded = [c for c in calls if c is not None]
    assert len(seeded) == len(order)
    tpre.hfc_model.replay_seeds = [None, None]
    for n, call in zip(order, seeded):
        tpre.hfc_model.replay_seeds[n] = _replay(call)
    tpre.train_hfc_model(w, z_rands=z_rands, hle_zs=hle_zs)
    return jpre, tpre, w, jhidden


def test_what_the_flat_port_leaves_out_raises(tmp_path):
    """The hierarchical clusterer and the belief encoding, which raised in
    the flat port, now build and encode as the JAX package does: here over
    saved clusterers, beliefs estimated from the sample (the fits are
    ``test_hierarchical_preprocessor_matches_jax``); and the reference's
    pickled sklearn clusterers load."""
    jgen = JaxGenerator(size=16, key=jax.random.PRNGKey(0))
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jgen.params))
    rs = np.random.RandomState(6)
    saved = str(tmp_path / "saved")
    os.makedirs(saved)
    for n, k in enumerate((3, 4)):
        np.savez_compressed(os.path.join(saved, f"clusterer_layer_{n}.npz"),
                            centers=rs.randn(k, 1024).astype(np.float32) * 0.3)
    w = (rs.randn(1, 512) * 0.5).astype(np.float32)
    for over in (dict(hfc_algo="hfc_kmeans_hier"), dict(hier_encode=True)):
        args = dict(_prep_args(saved, True), **over)
        jpre = jkm.HFCPreprocessor(jgen, _MC(), **args)
        tpre = tkm.HFCPreprocessor(gen, _MC(), device="cpu", **args)
        tpre.mean_latent = _t(jpre.mean_latent)
        assert isinstance(tpre.hfc_model, tkm.HierarchicalKMeansHFC) == (
            "hfc_algo" in over)
        tz, tlab = tpre.predict_hfc_vectors(w)
        jz, jlab = jpre.predict_hfc_vectors(w)
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        for a, b in zip(tlab, jlab):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="hfc_algo"):
        tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                            **dict(_prep_args(saved, True), hfc_algo="hier"))
    # the reference's pickled sklearn clusterers load (they raised before
    # the importer was ported): the centers JAX's importer reads, and the
    # one-shot features over them
    import pickle

    from sklearn.cluster import KMeans

    sav = tmp_path / "sav"
    os.makedirs(sav)
    probe = tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                                **dict(_prep_args(str(tmp_path / "probe")),
                                       train=False))
    w = np.random.RandomState(3).randn(512).astype(np.float32)
    groups = probe._grouped_features(probe._w_plus(w))
    for n, k in enumerate((3, 4)):
        x = groups[n].reshape(-1, groups[n].shape[-1]).numpy()
        with open(sav / f"clusterer_layer_{n}.sav", "wb") as f:
            pickle.dump(KMeans(n_clusters=k, n_init=1, random_state=n).fit(x), f)
    pre = tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                              **dict(_prep_args(str(sav), True), train=False))
    pre.mean_latent = probe.mean_latent
    for n in range(2):
        np.testing.assert_array_equal(
            pre.hfc_model.centers[n].numpy(),
            np.asarray(jkm.import_sklearn_clusterer(
                str(sav / f"clusterer_layer_{n}.sav"))))
    feats, labels = pre.predict_hfc_vectors(w)
    assert feats.shape == (1, 16, 16, 7)
    for n in range(2):
        np.testing.assert_array_equal(
            labels[n].reshape(-1).numpy(),
            tkm.kmeans_predict(groups[n].reshape(-1, groups[n].shape[-1]),
                               pre.hfc_model.centers[n]).numpy())
    with pytest.raises(FileNotFoundError):
        tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                            **dict(_prep_args(str(tmp_path / "none"), True),
                                   train=False))


@pytest.mark.parametrize("over", [
    dict(hfc_algo="hfc_kmeans_hier", hier_encode=True),
    dict(hfc_algo="hfc_kmeans_hier"),
    dict(hier_encode=True),
], ids=["hier-fit-and-beliefs", "hier-fit", "flat-fit-and-beliefs"])
def test_hierarchical_preprocessor_matches_jax(tmp_path, monkeypatch, over):
    """``train_hfc_model`` with the hierarchical fit (layer 0's seedings
    replayed, layer 1 from its parent's centers) and the beliefs over the
    JAX run's two ``hle_samples`` latents; ``beliefs.npz`` read back by
    both packages; the one-shot features of the trained and the loaded
    beliefs."""
    jpre, tpre, w, _ = _fit_both(tmp_path, monkeypatch, **over)
    for a, b in zip(tpre.hfc_model.centers, jpre.hfc_model.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    names = set(os.listdir(tmp_path / "torch"))
    assert {"clusterer_layer_0.npz", "clusterer_layer_1.npz"} <= names
    assert ("model_stats.npz" in names) == ("hfc_algo" not in over)
    assert ("beliefs.npz" in names) == ("hier_encode" in over)
    if "hier_encode" in over:
        assert len(tpre.trained_beliefs) == 1
        assert tpre.trained_beliefs[0].shape == (4, 3)
        np.testing.assert_allclose(tpre.trained_beliefs[0].numpy(),
                                   np.asarray(jpre.trained_beliefs[0]), atol=1e-6)
        for d in ("jax", "torch"):  # each file read by either package
            fp = str(tmp_path / d / "beliefs.npz")
            for a, b in zip(tkm.load_belief_file(fp), jkm.load_belief_file(fp)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tz, tlab = tpre.predict_hfc_vectors(w)
    jz, jlab = jpre.predict_hfc_vectors(w)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    for a, b in zip(tlab, jlab):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the saved files, loaded outside training, give the same features
    load = tkm.HFCPreprocessor(
        tpre.model, _MC(), device="cpu",
        **dict(_prep_args(str(tmp_path / "torch"), True), train=False, **over))
    load.mean_latent = tpre.mean_latent
    lz, _ = load.predict_hfc_vectors(w)
    assert torch.equal(lz, tz)


def test_multi_sample_encoding_takes_the_latents_passed_in(tmp_path):
    """``multi_sample_hierarchical_encoding`` over latents passed in: the
    running half-mix of each sample's estimate, as JAX computes it from
    the same latents (its key replaced by a stub that hands them out)."""
    jgen = JaxGenerator(size=16, key=jax.random.PRNGKey(0))
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jgen.params))
    rs = np.random.RandomState(5)
    centers = [rs.randn(3, 1024).astype(np.float32) * 0.3,
               rs.randn(4, 1024).astype(np.float32) * 0.3]
    dirs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in dirs.values():
        os.makedirs(d)
        for n, c in enumerate(centers):
            np.savez_compressed(os.path.join(d, f"clusterer_layer_{n}.npz"),
                                centers=c)
    kw = dict(hier_encode=True, train=False)
    jpre = jkm.HFCPreprocessor(jgen, _MC(), **dict(_prep_args(dirs["jax"], True), **kw))
    tpre = tkm.HFCPreprocessor(gen, _MC(), device="cpu",
                               **dict(_prep_args(dirs["torch"], True), **kw))
    tpre.mean_latent = _t(jpre.mean_latent)
    zs = rs.randn(3, 1, 512).astype(np.float32)
    feed = iter(zs)
    orig = jax.random.normal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, *a, **k: jnp.asarray(next(feed))
                   if shape == (1, 512) else orig(key, shape, *a, **k))
        want = jpre.multi_sample_hierarchical_encoding(3, 2)
    got = tpre.multi_sample_hierarchical_encoding(3, 2, zs=_t(zs))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    # the half-mix, not the mean: the last sample weighs 1/2
    one = [tpre.multi_sample_hierarchical_encoding(1, 2, zs=_t(zs[i:i + 1]))[0]
           for i in range(3)]
    torch.testing.assert_close(got[0], 0.25 * (one[0] + one[1]) + 0.5 * one[2])


def test_load_belief_file_both_formats(tmp_path):
    """beliefs.npz in this repo's layout (one entry per matrix) and the
    reference's (one object array holding the list), as JAX reads them."""
    rs = np.random.RandomState(1)
    mats = [rs.rand(3, 4).astype(np.float32), rs.rand(4, 6).astype(np.float32)]
    repo_fp, ref_fp = str(tmp_path / "repo.npz"), str(tmp_path / "ref.npz")
    np.savez_compressed(repo_fp, *mats)
    np.savez_compressed(ref_fp, np.asarray(mats, dtype=object))
    # more than ten matrices sort arr_2 before arr_10
    many_fp = str(tmp_path / "many.npz")
    many = [np.full((2, 2), i, np.float32) for i in range(12)]
    np.savez_compressed(many_fp, *many)
    for fp, want in ((repo_fp, mats), (ref_fp, mats), (many_fp, many)):
        got = tkm.load_belief_file(fp)
        jgot = jkm.load_belief_file(fp)
        assert len(got) == len(jgot) == len(want)
        for a, b, c in zip(got, jgot, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), c)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_region_beliefs_device_matches_host_loop_and_jax():
    """The one-hot products equal the host loop (label 0's column and
    absent labels' columns zero) and JAX's device form."""
    rs = np.random.RandomState(3)
    for kp, kc in [(4, 7), (8, 3), (5, 5)]:
        curr = rs.randint(0, kc, size=(2, 16, 16)).astype(np.uint8)
        prev = rs.randint(0, kp, size=(2, 16, 16)).astype(np.uint8)
        curr[curr == kc - 1] = 1  # an absent label
        host = tkm._region_beliefs(curr, prev, (kp, kc))
        np.testing.assert_array_equal(host, jkm._region_beliefs(curr, prev, (kp, kc)))
        dev = tkm.region_beliefs_device(_t(curr), _t(prev), (kp, kc))
        np.testing.assert_allclose(dev.numpy(), host, atol=1e-6)
        assert dev[:, 0].abs().sum() == 0 and dev[:, kc - 1].abs().sum() == 0
        jdev = jkm.region_beliefs_device(curr.astype(np.int32),
                                         prev.astype(np.int32), (kp, kc))
        np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))


def test_beliefs_none_equals_the_estimate_fed_back():
    """``hier_encode`` with ``beliefs=None`` estimates the matrices from the
    batch; feeding that estimate back as trained beliefs gives the same
    features and labels, and both equal JAX's."""
    rs = np.random.RandomState(0)
    cpl = [3, 5]
    groups = [rs.randn(2, 8, 8, 6).astype(np.float32),
              rs.randn(2, 16, 16, 4).astype(np.float32)]
    centers = [rs.randn(3, 6).astype(np.float32), rs.randn(5, 4).astype(np.float32)]
    tg, tc = [_t(g) for g in groups], [_t(c) for c in centers]
    auto, auto_labels = tkm.hfc_predict_from_features(tg, tc, cpl, 16, True, None)
    lab0 = tkm.kmeans_predict(tg[0].reshape(-1, 6), tc[0]).reshape(2, 8, 8)
    lab1 = tkm.kmeans_predict(tg[1].reshape(-1, 4), tc[1]).reshape(2, 16, 16)
    curr = tkm.resize_nearest(lab0[..., None].float(), (16, 16))[..., 0]
    beliefs = [tkm.region_beliefs_device(curr, lab1, (cpl[1], cpl[0]))]
    fed, fed_labels = tkm.hfc_predict_from_features(tg, tc, cpl, 16, True, beliefs)
    assert torch.equal(auto, fed)
    for a, b in zip(auto_labels, fed_labels):
        assert torch.equal(a, b)
    jz, jlabels = jkm.hfc_predict_from_features(
        [jnp.asarray(g) for g in groups], [jnp.asarray(c) for c in centers],
        cpl, 16, True, None)
    np.testing.assert_array_equal(auto.numpy(), np.asarray(jz))
    for a, b in zip(auto_labels, jlabels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert auto.shape == (2, 16, 16, 8)


def test_hierarchical_fit_matches_jax(tmp_path, monkeypatch):
    """``HierarchicalKMeansHFC.hierarchical_fit`` with layer 0's seedings
    replayed: the propagated twins (equal centers, the second kept empty by
    the argmin's first index) and Lloyd's iterations from them."""
    feats = [_blobs(n=64, d=6, k=3, seed=4).reshape(1, 8, 8, 6),
             _blobs(n=256, d=4, k=6, seed=5).reshape(1, 16, 16, 4)]
    base = dict(n_layers=2, clusters_per_layer=[3, 6], out_size=16)
    calls = _record_fits(monkeypatch)
    jm = jkm.HierarchicalKMeansHFC({}, dict(base, out_dir=str(tmp_path / "j")))
    jm.hierarchical_fit([jnp.asarray(f) for f in feats])
    tm = tkm.HierarchicalKMeansHFC({}, dict(base, out_dir=str(tmp_path / "t")))
    tm.replay_seeds = [_replay(calls[0]), None]
    assert calls[1] is None  # layer 1 starts from its parent's centers
    tm.hierarchical_fit([_t(f) for f in feats])
    for a, b in zip(tm.centers, jm.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    init = tm.calculate_cluster_centers(_t(feats[0]), _t(feats[1]),
                                        tkm.kmeans_predict(_t(feats[0]).reshape(-1, 6),
                                                           tm.centers[0]), 1)
    assert init.shape == (6, 4) and torch.equal(init[0::2], init[1::2])
    jinit = jm.calculate_cluster_centers(
        jnp.asarray(feats[0]), jnp.asarray(feats[1]),
        jkm.kmeans_predict(jnp.asarray(feats[0]).reshape(-1, 6), jm.centers[0]), 1)
    np.testing.assert_allclose(init.numpy(), jinit, **TOL)


def test_legacy_hierarchical_kmeans_matches_jax(tmp_path, monkeypatch):
    """``LegacyHierarchicalKMeansHFC``: the fine-to-coarse fit with every
    layer's seedings replayed, and ``hierarchical_predict``'s label maps and
    one-hot concat (tests/test_pipeline.py:266's shapes)."""
    rs = np.random.RandomState(1)
    feats = [rs.rand(1, 8, 8, 6).astype(np.float32),
             rs.rand(1, 16, 16, 4).astype(np.float32)]
    base = dict(n_layers=2, clusters_per_layer=[3, 4], out_size=16)
    calls = _record_fits(monkeypatch)
    jm = jkm.LegacyHierarchicalKMeansHFC({}, dict(base, out_dir=str(tmp_path / "j")))
    jm.fit([jnp.asarray(f) for f in feats])
    tm = tkm.LegacyHierarchicalKMeansHFC({}, dict(base, out_dir=str(tmp_path / "t")))
    tm.replay_seeds = [_replay(calls[1]), _replay(calls[0])]  # fitted 1, then 0
    tm.fit([_t(f) for f in feats])
    for a, b in zip(tm.centers, jm.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    labels, maps = tm.hierarchical_predict([_t(f) for f in feats])
    jlabels, jmaps = jm.hierarchical_predict([jnp.asarray(f) for f in feats])
    assert labels.shape == (1, 2, 16, 16) and maps.shape == (1, 16, 16, 7)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(maps.numpy(), np.asarray(jmaps))
    s = maps.reshape(-1, 7)
    assert torch.equal(s[:, :3].sum(-1), torch.ones(256))
    assert torch.equal(s[:, 3:].sum(-1), torch.ones(256))
