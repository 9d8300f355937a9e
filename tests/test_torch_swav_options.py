"""What the hfc_with_swav slices left out, held against the JAX package on
the CPU: serving with a 1-layer or 2-layer SwAV projection (per-image
BatchNorm statistics), bilinear ``hf_interp``, the reference's pickled
sklearn clusterers, SwAV's local loss, its elastic snapshots and test-image
plots, and ``load_image`` / ``utils/fits.py``.

Tolerances (float32 on both sides, sums in another order): the pipelines'
predicted labels equal on at least 99.9% of pixels and the mean mask IoU
within 1e-3 (tests/test_torch_pipeline.py's); a request of B against B
requests of 1 on one side: labels equal, logits within 1e-4 absolute;
bilinear projections 1e-5; the SwAV step's losses 1e-5 and params 1e-6
absolute (tests/test_torch_swav.py's); snapshots resume bit for bit.
"""

import os
import pickle
import sys
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ganecdotes_tpu.models.stylegan2.generator import (  # noqa: E402
    Generator as JaxGenerator,
)
from ganecdotes_tpu.selfsup import embed as jembed  # noqa: E402
from ganecdotes_tpu.selfsup import heads as jheads  # noqa: E402
from ganecdotes_tpu.selfsup import kmeans as jkm  # noqa: E402
from ganecdotes_tpu.selfsup import swav as jswav  # noqa: E402
from ganecdotes_tpu.utils import fits as jfits  # noqa: E402
from ganecdotes_tpu.utils import visualization as jvis  # noqa: E402
from ganecdotes_tpu.utils.serialization import (  # noqa: E402
    save_pytree as jax_save_pytree,
)
from ganecdotes_torch.models.stylegan2.convert import (  # noqa: E402
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline  # noqa: E402
from ganecdotes_torch.pipeline.serving import OneShotServer  # noqa: E402
from ganecdotes_torch.selfsup import embed as tembed  # noqa: E402
from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply  # noqa: E402
from ganecdotes_torch.selfsup import kmeans as tkm  # noqa: E402
from ganecdotes_torch.selfsup import lars as tlars  # noqa: E402
from ganecdotes_torch.selfsup import swav as tswav  # noqa: E402
from ganecdotes_torch.utils import fits as tfits  # noqa: E402
from ganecdotes_torch.utils import visualization as tvis  # noqa: E402
from test_pipeline import TINY_SWAV  # noqa: E402
from test_torch_pipeline import (  # noqa: E402
    HLEN,
    N_TEST,
    NCLASSES,
    NPROTO,
    _evaluate_mode,
    _samples,
    _write_configs,
)
from test_torch_swav import (  # noqa: E402
    ACT_TOL,
    PARAM_TOL,
    PATCH,
    SIZE as STEP_SIZE,
    _clustering_args,
    _jax_draws,
    _jax_generator,
    _step_configs,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _swav_config(projn_nw="linear", interp="nearest"):
    body = TINY_SWAV.replace("projn_nw='linear'", f"projn_nw='{projn_nw}'")
    return body.replace("hf_interp='nearest'", f"hf_interp='{interp}'")


# ---------------------------------------------------------------------------
# non-linear projections and bilinear features through the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("projn_nw,interp", [("1-layer", "nearest"),
                                             ("2-layer", "nearest"),
                                             ("linear", "bilinear")])
def test_pipeline_serves_what_does_not_fold_as_jax_does(tmp_path, projn_nw,
                                                        interp):
    """The tiny pipeline through its test block with a non-linear projection
    or bilinear features, against the JAX pipeline (which serves these
    unfused, the projection vmapped over the batch): the same latents,
    labels, swav_params.npz, generator, mean latents and head init."""
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)),
                         seg=_swav_config(projn_nw, interp))
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(21), HLEN, NCLASSES, NPROTO, projn_nw))
    seg_init = jax.tree.map(np.asarray, jheads.init_one_shot_segmentor(
        jax.random.PRNGKey(22), NCLASSES, 4, "XXS"))
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in outs.values():
        os.makedirs(d)
        jax_save_pytree(os.path.join(d, "swav_params.npz"), ssl)

    jpipe = JaxPipeline(out_dir=outs["jax"], model="ffhq-256",
                        segmentor="hfc_with_swav", num_test_samples=N_TEST,
                        custom=cfg)
    _evaluate_mode(jpipe)
    jpipe.segmentor_init_params = jax.tree.map(jnp.asarray, seg_init)
    jpipe.run_pipeline()

    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    pipe = OneShotPipeline(out_dir=outs["torch"], model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=N_TEST,
                           custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    _evaluate_mode(pipe)
    pipe.preprocessor = pipe._build_ssl_preprocessor()
    pipe.preprocessor.mean_latent = torch.from_numpy(
        np.array(jpipe.preprocessor.mean_latent))
    pipe.segmentor_init_params = seg_init
    pipe.run_pipeline()
    assert not pipe.server.foldable
    assert pipe.preprocessor.pretrain_count == 0

    jpred = np.load(os.path.join(outs["jax"], "tests", "label_predictions.npy"))
    tpred = np.load(os.path.join(outs["torch"], "tests", "label_predictions.npy"))
    assert tpred.shape == jpred.shape == (N_TEST, 32, 32)
    assert (tpred == jpred).mean() >= 0.999
    assert abs(pipe.mean_mask_iou - jpipe.mean_mask_iou) <= 1e-3


def _server(projn_nw, interp, size=32, seed=3):
    jgen = JaxGenerator(size=size, key=jax.random.PRNGKey(seed))
    classes = ["c%d" % i for i in range(4)]
    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=64,
                         gen_args=dict(size=size, style_dim=512, n_mlp=2),
                         classes=classes)
    hlen = 1300
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(
            hlen=hlen, nclasses=NCLASSES, nprototypes=NPROTO,
            projn_nw=projn_nw, hf_interp=interp)),
        seg_args=dict(size="XXS", in_ch=NCLASSES))
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(seed + 1), hlen, NCLASSES, NPROTO, projn_nw))
    return OneShotServer(
        mc, sc, device="cpu",
        gen=from_jax_generator_params(jax.tree.map(np.asarray, jgen.params)),
        ssl_params=from_jax_params(ssl), seed=seed)


@pytest.mark.parametrize("projn_nw,interp", [("1-layer", "nearest"),
                                             ("2-layer", "nearest"),
                                             ("2-layer", "bilinear")])
def test_a_request_of_b_equals_b_requests_of_one(projn_nw, interp):
    """The embedding and head of a request of 3 against each image's alone,
    on the same features (the synthesis itself is not batch-invariant to
    the last bit); the request's labels are the argmax of those logits."""
    server = _server(projn_nw, interp)
    z = np.random.RandomState(4).randn(3, 512).astype(np.float32)
    _, labels, z0 = server.serve(z)
    with torch.inference_mode():
        _, feats = server._synthesize(z, False)
        emb = server._project(feats)
        logits = one_shot_segmentor_apply(server.seg_params, emb, server.seg_size)
        assert torch.equal(labels, logits.argmax(-1))
        assert torch.equal(z0, emb[:1].argmax(-1))
        for i in range(3):
            emb_i = server._project([f[i : i + 1] for f in feats])
            logits_i = one_shot_segmentor_apply(server.seg_params, emb_i,
                                                server.seg_size)
            torch.testing.assert_close(emb[i : i + 1], emb_i, atol=1e-4, rtol=0)
            torch.testing.assert_close(logits[i : i + 1], logits_i, atol=1e-4,
                                       rtol=0)
            assert torch.equal(labels[i : i + 1], logits_i.argmax(-1))
        if projn_nw == "2-layer":
            # statistics over the whole request would couple the images
            z1 = tembed.project_feature_maps(
                feats, server.ssl_params["projection"][0]["weight"],
                hlen=server.hlen, interp=interp)
            coupled = tswav.projection_tail(
                server.ssl_params, z1.reshape(1, -1, z1.shape[-1]),
                projn_nw).reshape(z1.shape)
            assert (coupled - emb).abs().max() > 1e-3


@pytest.mark.parametrize("hlen", [None, 30])
def test_bilinear_feature_maps_and_projection_match_jax(hlen):
    rs = np.random.RandomState(5)
    feats = [rs.randn(2, s, s, c).astype(np.float32)
             for s, c in ((4, 8), (8, 16), (8, 6), (16, 12))]
    w = rs.randn(hlen or 42, 7).astype(np.float32)
    fj = [jnp.asarray(f) for f in feats]
    ft = [_t(f) for f in feats]
    np.testing.assert_allclose(
        tembed.pixel_feature_maps(ft, hlen, interp="bilinear").numpy(),
        np.asarray(jembed.pixel_feature_maps(fj, hlen, interp="bilinear")),
        atol=1e-5, rtol=0)
    got = tembed.project_feature_maps(ft, _t(w), hlen, interp="bilinear")
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jembed.project_feature_maps(fj, jnp.asarray(w), hlen,
                                               interp="bilinear")),
        atol=1e-5, rtol=0)
    # and the level-decomposed form equals the explicit concat's product
    want = tembed.pixel_feature_maps(ft, hlen, interp="bilinear") @ _t(w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the reference's pickled sklearn clusterers
# ---------------------------------------------------------------------------


def _pickled_kmeans(path, k=5, d=6, seed=0):
    from sklearn.cluster import KMeans

    x = np.random.RandomState(seed).randn(200, d).astype(np.float32)
    km = KMeans(n_clusters=k, n_init=2, random_state=seed).fit(x)
    with open(path, "wb") as f:
        pickle.dump(km, f)
    return km, x


@pytest.mark.parametrize("k,d", [(5, 6), (12, 3)])
def test_sklearn_clusterer_imports_as_jax_imports_it(tmp_path, k, d):
    path = str(tmp_path / "clusterer_layer_0.sav")
    km, x = _pickled_kmeans(path, k, d)
    got = tkm.import_sklearn_clusterer(path)
    want = np.asarray(jkm.import_sklearn_clusterer(path))
    assert got.dtype == torch.float32 and got.shape == (k, d)
    np.testing.assert_array_equal(got.numpy(), want)
    pred = tkm.kmeans_predict(_t(x), got).numpy()
    np.testing.assert_array_equal(pred, km.predict(x))
    np.testing.assert_array_equal(
        pred, np.asarray(jkm.kmeans_predict(jnp.asarray(x), jnp.asarray(want))))


def test_sklearn_clusterer_without_sklearn_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "clusterer_layer_0.sav")
    _pickled_kmeans(path)
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="scikit-learn.*npz"):
        tkm.import_sklearn_clusterer(path)


# ---------------------------------------------------------------------------
# SwAV: the local loss
# ---------------------------------------------------------------------------


def _local_loss_steps(projn_nw, seed):
    """Two steps with ``add_local_loss`` from equal params and equal draws:
    [(JAX loss, port loss)] and both params after the second step."""
    params, meta, gen = _jax_generator()
    k_ssl, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    hlen, ncls = 2560, 8  # every level of the 16^2 generator
    ssl = jswav.init_swav_params(k_ssl, hlen, ncls, 16, projn_nw)
    mean = (np.random.RandomState(32).randn(1, 512) * 0.3).astype(np.float32)
    mc, pa, sa, sk = _step_configs(0.05, 0.1, "uniform")
    sa.update(add_local_loss=True, projn_nw=projn_nw, hlen=hlen)
    opt, step = jswav.make_swav_train_step(meta, mc, pa, sa, sk,
                                           jnp.asarray(mean),
                                           (STEP_SIZE, STEP_SIZE))
    topt, tstep = tswav.make_swav_train_step(gen.meta, mc, pa, sa, sk, _t(mean),
                                             (STEP_SIZE, STEP_SIZE))
    jp, js = ssl, opt.init(ssl)
    tp = from_jax_params(jax.tree.map(np.asarray, ssl))
    ts = topt.init(tp)
    losses = []
    for it, key in enumerate((k1, k2)):
        jp, js, jl = step(params, jp, js, key, it)
        draws = _jax_draws(key, meta, 2, sa["num_patches"],
                           STEP_SIZE * STEP_SIZE, PATCH)
        tp, ts, tl = tstep(gen, tp, ts, draws, it)
        losses.append((float(jl), tl.item()))
    return losses, jp, tp


@pytest.mark.parametrize("projn_nw", ["linear", "1-layer", "2-layer"])
def test_local_loss_step_matches_jax(projn_nw):
    """The views' perturbed blocks differ in both steps of this key (layers
    (0, 1), then (1, 0)); for the JAX package's NaN on other keys see the
    next test."""
    losses, jp, tp = _local_loss_steps(projn_nw, seed=32)
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, **ACT_TOL)
    for a, b in zip(jax.tree.leaves(jp), tlars.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL)


def test_jax_local_loss_gradient_is_nan_where_a_masked_pixel_is_all_zero():
    """A fault of the JAX package, recorded and left unchanged (ROADMAP §3):
    in this key's second step one picked pixel of the masked target view
    is zero at every level that is left (a corner the rotation filled with
    zeros, its block's coarse levels masked). JAX's gradient of
    ``jnp.linalg.norm`` at 0 is NaN, so its projection weight turns NaN;
    torch's is 0, so the port's stays finite. The losses agree."""
    losses, jp, tp = _local_loss_steps("linear", seed=31)
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, **ACT_TOL)
    assert np.isnan(np.asarray(jp["projection"][0]["weight"])).any()
    assert all(torch.isfinite(t).all() for t in tlars.tree_leaves(tp))


# ---------------------------------------------------------------------------
# SwAV: snapshots and plots
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    warning = info


def _swav(tmp_path, logger=None, **over):
    _, _, gen = _jax_generator()
    mc, pa, sa, sk = _clustering_args(tmp_path)
    sa.update(over)
    return tswav.SwAVClustering(gen, mc, pa, sa, sk, out_dir=str(tmp_path),
                                device="cpu", seed=5, logger=logger)


def _leaves_equal(a, b):
    for x, y in zip(tlars.tree_leaves(a), tlars.tree_leaves(b)):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_snapshot_resume_is_bit_equal_and_success_deletes_it(tmp_path):
    whole = _swav(tmp_path / "whole", num_epochs=3, checkpoint_every=1)
    whole.pretrain()
    snap = os.path.join(whole.out_dir, "swav_pretrain_state.npz")
    assert not os.path.exists(snap)  # deleted on success

    d = tmp_path / "broken"
    broken = _swav(d, num_epochs=3, checkpoint_every=1)
    broken._abort_after_epoch = 2
    with pytest.raises(tswav._SimulatedPreemption):
        broken.pretrain()
    snap = os.path.join(str(d), "swav_pretrain_state.npz")
    assert os.path.exists(snap)
    log = _Log()
    resumed = _swav(d, logger=log, num_epochs=3, checkpoint_every=1)
    resumed.pretrain()
    assert any("Resuming SwAV pretraining from epoch 2" in m for m in log.lines)
    _leaves_equal(resumed.ssl_params, whole.ssl_params)
    assert not os.path.exists(snap)


def test_snapshot_of_another_config_restarts_from_epoch_zero(tmp_path):
    d = tmp_path / "o"
    broken = _swav(d, num_epochs=3, checkpoint_every=1)
    broken._abort_after_epoch = 1
    with pytest.raises(tswav._SimulatedPreemption):
        broken.pretrain()
    log = _Log()
    other = _swav(d, logger=log, num_epochs=2, checkpoint_every=1)
    other.pretrain()
    assert any("starting from epoch 0" in m for m in log.lines), log.lines
    fresh = _swav(tmp_path / "fresh", num_epochs=2, checkpoint_every=1)
    fresh.pretrain()
    _leaves_equal(other.ssl_params, fresh.ssl_params)
    # a truncated snapshot is ignored the same way
    with open(os.path.join(str(d), "swav_pretrain_state.npz"), "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    log = _Log()
    again = _swav(d, logger=log, num_epochs=2, checkpoint_every=1)
    again.pretrain()
    assert any("starting from epoch 0" in m for m in log.lines), log.lines
    _leaves_equal(again.ssl_params, fresh.ssl_params)


def test_plot_predictions_take_the_whole_batchs_statistics_as_jax_does(
        tmp_path):
    """``predict_swav_codes`` (the plot grid's path) with a 2-layer head
    against the JAX package's batched ``swav_predict_from_features`` on the
    same features, scores within 1e-4: both take the BatchNorm statistics
    over the whole batch, where the serving path takes each image's own."""
    from ganecdotes_torch.models.stylegan2.generator import generator_forward

    swav = _swav(tmp_path, projn_nw="2-layer")
    sa = swav.swav_args
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(9), sa["hlen"], sa["nclasses"], sa["nprototypes"],
        "2-layer"))
    swav.ssl_params = from_jax_params(ssl)
    z = np.random.RandomState(9).randn(3, 512).astype(np.float32)
    preds, labels = swav.predict_swav_codes(z, input_is_latent=False)
    with torch.no_grad():
        _, feats = generator_forward(
            swav.model, [_t(z)], input_is_latent=False,
            truncation=swav.truncation, truncation_latent=swav.mean_latent,
            ops=swav.ops)
        per_image = tswav.swav_predict_from_features(
            swav.ssl_params, feats, sa["hlen"], sa["nclasses"], "2-layer")
    want = jswav.swav_predict_from_features(
        jax.tree.map(jnp.asarray, ssl), [jnp.asarray(f.numpy()) for f in feats],
        sa["hlen"], sa["nclasses"], "2-layer", "nearest")
    assert preds.shape == (3,) + tuple(want.shape[1:])
    np.testing.assert_allclose(preds.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert torch.equal(labels, preds.argmax(-1))
    assert (per_image - preds).abs().max() > 1e-3


def test_plot_test_images_writes_each_epochs_grid(tmp_path, monkeypatch):
    swav = _swav(tmp_path, num_epochs=2, plot_test_images=True, max_masks=2)
    swav.pretrain()
    for e in range(2):
        assert os.path.getsize(tmp_path / "swav" / f"test_epoch_{e}.png") > 0
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    with pytest.raises(ImportError, match="matplotlib"):
        _swav(tmp_path / "none", plot_test_images=True).pretrain()


# ---------------------------------------------------------------------------
# quick_imshow, load_image, FITS
# ---------------------------------------------------------------------------


def test_quick_imshow_draws_the_jax_figure(tmp_path):
    import matplotlib.pyplot as plt

    rs = np.random.RandomState(6)
    ims = [rs.rand(8, 8) for _ in range(5)] + [rs.rand(8, 8, 3)]
    figs = []
    for mod, name in ((tvis, "t"), (jvis, "j")):
        fig = mod.quick_imshow(2, 3, ims, colorbar=True, colormap="gray",
                               fname=str(tmp_path / f"{name}.png"))
        figs.append(fig)
    (tf, jf) = figs
    assert len(tf.axes) == len(jf.axes) == 6 + 6  # six images, six colorbars
    for ta, ja in zip(tf.axes[:6], jf.axes[:6]):
        np.testing.assert_array_equal(ta.images[0].get_array(),
                                      ja.images[0].get_array())
        assert ta.images[0].get_cmap().name == "gray"
    t_png = plt.imread(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(t_png, plt.imread(str(tmp_path / "j.png")))
    for f in figs:
        plt.close(f)


@pytest.mark.parametrize("ext", [".png", ".jpg", ".tiff", ".npy", ".npz",
                                 ".fits"])
def test_load_image_matches_jax(tmp_path, ext):
    from PIL import Image

    img = (np.random.RandomState(7).rand(9, 11, 3) * 255).astype(np.uint8)
    path = str(tmp_path / f"im{ext}")
    if ext in (".png", ".jpg", ".tiff"):
        Image.fromarray(img).save(path)
    elif ext == ".npy":
        np.save(path, img)
    elif ext == ".npz":
        np.savez(path, img)
    else:
        tfits.save_fits_data(path, img.astype(np.float32))
    got, want = tvis.load_image(path), jvis.load_image(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if ext != ".jpg":
        np.testing.assert_array_equal(np.asarray(got, np.uint8), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.int64,
                                   np.float32, np.float64])
def test_fits_round_trips_between_the_packages(tmp_path, dtype):
    arr = (np.random.RandomState(8).rand(3, 5, 7) * 100).astype(dtype)
    tfits.save_fits_data(str(tmp_path / "t.fits"), arr)
    jfits.save_fits_data(str(tmp_path / "j.fits"), arr)
    assert (open(tmp_path / "t.fits", "rb").read()
            == open(tmp_path / "j.fits", "rb").read())
    for name in ("t.fits", "j.fits"):
        got = tfits.read_fits_data(str(tmp_path / name))
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(
            jfits.read_fits_data(str(tmp_path / name)), got)
