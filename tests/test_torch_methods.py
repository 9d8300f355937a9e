"""The port's one-shot pipeline for RepurposeGAN, DatasetGAN,
hfc_with_simclr and hfc_kmeans, and their CLIs, on the CPU, at the tiny
configs of tests/test_pipeline.py (a 32^2 generator, n_mlp 2, 4 classes, 6
fine-tune epochs in chunks of 3, 3 test samples).

Each method against the JAX pipeline, as tests/test_torch_pipeline.py does
for hfc_with_swav: the SimCLR params and the k-means clusterers (random
centers) are saved files both packages load with train_hfc False; the
generator, the mean latents (the pipeline's and its preprocessor's) and
the head's init (the pixel classifier's BN state too) are carried across.
Tolerances (float32 on both sides, summed in other orders): the one-shot
features 1e-4 absolute + relative; each chunk's fine-tune loss 1e-5
relative, DatasetGAN's 1e-4 (its BatchNorm divides by the batch's standard
deviation); the trained BN state 1e-4; the predicted labels equal on at
least 99.9% of pixels; the mean mask IoU within 1e-3. Then each method's
folded request against its unfused oracle: the image equal, logits within
1e-4 * max(1, max |unfused|), labels on 99.9% of pixels. Last, the
pretrain and evaluate CLIs of the two methods that save a preprocessor.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.utils.serialization import save_pytree as jax_save_pytree
from ganecdotes_torch.configs import mapper as tmapper
from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.ops import _build
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
from test_pipeline import TINY_DG, TINY_KMEANS, TINY_RP, TINY_SIMCLR
from test_torch_pipeline import (
    N_TEST,
    SIZE,
    _evaluate_mode,
    _majority_class_mean_iou,
    _record_jax_losses,
    _samples,
    _write_configs,
    one_torch_thread,  # noqa: F401  (the autouse fixture)
)

METHOD_CONFIGS = {"repurposegan": TINY_RP, "datasetgan": TINY_DG,
                  "hfc_with_simclr": TINY_SIMCLR, "hfc_kmeans": TINY_KMEANS}
# the tiny configs' head input widths: the 7 levels' concat of a 32^2
# generator, SimCLR's nclasses, k-means' clusters per layer [4, 8]
METHOD_IN_CH = {"repurposegan": 3584, "datasetgan": 3584,
                "hfc_with_simclr": 16, "hfc_kmeans": 12}
KMEANS_DIMS = [(4, 1024), (8, 1024)]  # (k, channels) of the 8^2 and 16^2 blocks


def _method_files(method, dirs):
    """The saved preprocessor state both packages load: SimCLR params, or
    the k-means clusterers (random centers) in the JAX layout."""
    if method == "hfc_with_simclr":
        from ganecdotes_tpu.selfsup import simclr as jsim

        ssl = jax.tree.map(np.asarray, jsim.init_simclr_params(
            jax.random.PRNGKey(13), 3584, 16))
        for d in dirs:
            jax_save_pytree(os.path.join(d, "simclr_params.npz"), ssl)
    elif method == "hfc_kmeans":
        rs = np.random.RandomState(14)
        for n, (k, c) in enumerate(KMEANS_DIMS):
            centers = (rs.randn(k, c) * 0.5).astype(np.float32)
            for d in dirs:
                np.savez_compressed(os.path.join(d, f"clusterer_layer_{n}.npz"),
                                    centers=centers)


@pytest.mark.parametrize("method", list(METHOD_CONFIGS))
def test_method_pipeline_matches_jax_pipeline(tmp_path, monkeypatch, method):
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)),
                         seg=METHOD_CONFIGS[method])
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in outs.values():
        os.makedirs(d)
    _method_files(method, outs.values())
    key = jax.random.PRNGKey(12)
    in_ch = METHOD_IN_CH[method]
    if method == "datasetgan":
        init, state = jheads.init_pixel_classifier(key, in_ch, 4)
        state = [{"mean": s["mean"] + 0.2, "var": s["var"] * 1.5,
                  "gamma": s["gamma"] * 0.9, "beta": s["beta"] + 0.1}
                 for s in state]
    else:
        size = {"repurposegan": "XS", "hfc_with_simclr": "XS", "hfc_kmeans": "S"}
        init, state = jheads.init_one_shot_segmentor(key, in_ch, 4,
                                                     size[method]), None
    init = jax.tree.map(np.asarray, init)
    state = None if state is None else jax.tree.map(np.asarray, state)

    jax_losses = _record_jax_losses(monkeypatch)
    jpipe = JaxPipeline(out_dir=outs["jax"], model="ffhq-256", segmentor=method,
                        num_test_samples=N_TEST, custom=cfg)
    _evaluate_mode(jpipe)
    jpipe.segmentor_init_params = jax.tree.map(jnp.asarray, init)
    if state is not None:
        jpipe.segmentor_init_state = jax.tree.map(jnp.asarray, state)
    jpipe.run_pipeline()

    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    _build.reset_launches()
    pipe = OneShotPipeline(out_dir=outs["torch"], model="ffhq-256",
                           segmentor=method, num_test_samples=N_TEST,
                           custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    _evaluate_mode(pipe)
    if method == "hfc_with_simclr":
        pipe.preprocessor = pipe._build_ssl_preprocessor()  # loads the params
    if jpipe.preprocessor is not None:
        pipe.preprocessor.mean_latent = torch.from_numpy(
            np.array(jpipe.preprocessor.mean_latent))
    pipe.segmentor_init_params = init
    pipe.segmentor_init_state = state
    pipe.run_pipeline()
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path
    if method == "hfc_with_simclr":
        assert pipe.preprocessor.pretrain_count == 0

    np.testing.assert_allclose(
        pipe.one_shot_train_features.numpy(),
        np.asarray(jpipe.one_shot_train_features), atol=1e-4, rtol=1e-4)
    losses = [loss for _, loss, _ in pipe.finetune_log]
    assert len(jax_losses) == len(losses) == 2
    rtol = 1e-4 if method == "datasetgan" else 1e-5
    for got, want in zip(losses, jax_losses):
        assert abs(got - want) <= rtol * abs(want), (losses, jax_losses)
    if method == "datasetgan":  # the trained BN state, kept for serving
        for a, b in zip(jpipe.segmentor_state, pipe.segmentor_state):
            for k in a:
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                           atol=1e-4, rtol=1e-4)
    jpred = np.load(os.path.join(outs["jax"], "tests", "label_predictions.npy"))
    tpred = np.load(os.path.join(outs["torch"], "tests", "label_predictions.npy"))
    assert tpred.shape == jpred.shape == (N_TEST, SIZE, SIZE)
    assert (tpred == jpred).mean() >= 0.999
    assert abs(pipe.mean_mask_iou - jpipe.mean_mask_iou) <= 1e-3

    # the folded request against its unfused oracle
    w = torch.as_tensor(pipe.test_latents[:N_TEST])
    img, logits, emb0 = pipe.server.infer_folded(w, input_is_latent=True)
    u_img, u_logits, u_emb0 = pipe.server.infer(w, input_is_latent=True)
    assert torch.equal(img, u_img)
    scale = max(1.0, u_logits.abs().max().item())
    assert (logits - u_logits).abs().max().item() <= 1e-4 * scale
    assert (logits.argmax(-1) == u_logits.argmax(-1)).float().mean() >= 0.999
    assert (emb0 is None) == (method != "hfc_with_simclr")
    if emb0 is not None:
        torch.testing.assert_close(emb0, u_emb0, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["hfc_with_simclr", "hfc_kmeans"])
def test_method_clis(tmp_path, monkeypatch, method):
    """The pretrain CLI fits SimCLR (simclr_params.npz) or the k-means
    clusterers (clusterer_layer_{n}.npz + model_stats.npz, which the JAX
    package loads), and the evaluate CLI loads them back without
    refitting. The k-means config is cut to n_init 2, max_iter 10."""
    from ganecdotes_tpu.selfsup import kmeans as jkm
    from ganecdotes_torch.cli import evaluate, pretrain

    seg = METHOD_CONFIGS[method].replace(
        "kmeans_args=dict(verbose=0)", "kmeans_args=dict(verbose=0, n_init=2, max_iter=10)")
    cfg = _write_configs(str(tmp_path), seg=seg)
    monkeypatch.setitem(tmapper.models, "ffhq-256", cfg["model"])
    monkeypatch.setitem(tmapper.segmentors, method, cfg["seg"])
    monkeypatch.setitem(tmapper.trainer, "supervised", cfg["trainer"])
    out = str(tmp_path / "out")
    argv = ["--method", method, "--out_dir", out, "--num_test_samples",
            str(N_TEST), "--device", "cpu"]
    saved = {"hfc_with_simclr": ["simclr_params.npz"],
             "hfc_kmeans": ["clusterer_layer_0.npz", "clusterer_layer_1.npz",
                            "model_stats.npz"]}[method]
    first = pretrain.main(argv)
    assert first.seg_config.train_hfc
    mtimes = {f: os.path.getmtime(os.path.join(out, f)) for f in saved}
    pipe = evaluate.main(argv)
    assert not pipe.seg_config.train_hfc
    for f in saved:
        assert os.path.getmtime(os.path.join(out, f)) == mtimes[f], f
    if method == "hfc_with_simclr":
        assert first.preprocessor.pretrain_count == 1
        assert pipe.preprocessor.pretrain_count == 0
    if method == "hfc_kmeans":
        base = dict(out_dir=out, n_layers=2, clusters_per_layer=[4, 8],
                    out_size=SIZE, presaved=True)
        jmodel = jkm.FlatKMeansHFC({}, base)
        for a, b in zip(jmodel.centers, pipe.preprocessor.hfc_model.centers):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in ("results.npz", "mask_iou_results.csv", "label_predictions.npy"):
        assert os.path.exists(os.path.join(out, "tests", name)), name
    assert pipe.mean_mask_iou > _majority_class_mean_iou(pipe)
