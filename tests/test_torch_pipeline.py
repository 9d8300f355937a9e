"""The port's one-shot pipeline (hfc_with_swav) and its CLIs, on the CPU,
at the tiny config of tests/test_pipeline.py (a 32^2 generator, n_mlp 2, 4
classes, 6 fine-tune epochs in chunks of 3, 3 test samples); the other
four methods are in tests/test_torch_methods.py.

(a) The whole pipeline against the JAX ``OneShotPipeline``: both read the
    same latent and label ``.npy`` files and the same ``swav_params.npz``
    with ``train_hfc`` False (as evaluate.py sets it); the generator params,
    both mean latents (the pipeline's and its SwAV preprocessor's) and the
    head's initial params are carried from the JAX side into the port.
    Tolerances (float32 on both sides, summed in other orders): the one-shot
    features 1e-4 absolute + relative; each chunk's fine-tune loss 1e-5
    relative; the head params 2e-5 absolute; the predicted labels equal on
    at least 99.9% of pixels; the CSVs with the same header and index and
    values within 1e-3.
(b) The port alone learns: SwAV pretrained on the CPU (by the pretrain
    CLI), the head beats the majority-class baseline (tests/test_pipeline.py's
    criterion).
(c) The presaved reload: a second pipeline loads swav_params.npz, never
    pretrains and does not rewrite it.
(d) The CLIs, with the config mapper pointed at the tiny configs.
"""

import csv
import os
import shutil
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_tpu.utils.serialization import save_pytree as jax_save_pytree
from ganecdotes_torch.configs import mapper as tmapper
from ganecdotes_torch.metrics.segmentation import get_mask_iou
from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.ops import _build
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
from test_pipeline import (
    TINY_KMEANS,
    TINY_MODEL,
    TINY_SIMCLR,
    TINY_SWAV,
    TINY_TRAINER,
)

N_TEST = 3
SIZE = 32
HLEN, NCLASSES, NPROTO = 3584, 16, 32  # TINY_SWAV's


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: torch on one thread (a thread pool only adds waits
    when test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_configs(d, latents=None, labels=None, seg=TINY_SWAV):
    model = TINY_MODEL
    if latents is not None:
        model = model.replace("/nonexistent/latents.pt", latents).replace(
            "/nonexistent/labels.pt", labels)
    cfg = {}
    for name, body in [("model", model), ("trainer", TINY_TRAINER),
                       ("seg", seg)]:
        p = os.path.join(d, f"{name}_config.py")
        with open(p, "w") as f:
            f.write(textwrap.dedent(body))
        cfg[name] = p
    return cfg


def _samples(d, seed=0):
    """1 one-shot + N_TEST test samples: w latents, and labels that follow
    the image plane (bands of the four classes), written as .npy files."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(N_TEST + 1, 512) * 0.6).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    labels = np.stack([((yy + xx * (1 + i % 2) + 3 * i) // 12) % 4
                       for i in range(N_TEST + 1)]).astype(np.int64)
    paths = os.path.join(d, "latents.npy"), os.path.join(d, "labels.npy")
    np.save(paths[0], w)
    np.save(paths[1], labels)
    return paths


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array(
        [[float(v) for v in r[1:]] for r in rows[1:]])


def _majority_class_mean_iou(pipe):
    labels = np.asarray(pipe.test_labels)[: pipe.num_test_samples]
    one_shot = pipe.one_shot_label.cpu().numpy().ravel()
    maj = int(np.bincount(one_shot).argmax())
    const = np.full_like(labels[0], maj)
    n_class = len(pipe.model_config.classes)
    return float(np.mean([np.mean([get_mask_iou(lbl, const, c)
                                   for c in range(n_class)]) for lbl in labels]))


def _evaluate_mode(pipe):
    """evaluate.py's settings (the baselines have no preprocessor args)."""
    pipe.seg_config.train_hfc = False
    if hasattr(pipe.seg_config, "hfc_prep_args"):
        pipe.seg_config.hfc_prep_args["train"] = False


# ---------------------------------------------------------------------------
# (a) against the JAX pipeline
# ---------------------------------------------------------------------------


def _record_jax_losses(monkeypatch):
    """The JAX pipeline keeps no loss: each chunk's, from its run_chunk."""
    from ganecdotes_tpu.pipeline import trainer as jtrainer

    losses = []
    make = jtrainer.make_supervised_finetune

    def recording(*args, **kwargs):
        optimizer, run_chunk = make(*args, **kwargs)

        def run(*a):
            out = run_chunk(*a)
            losses.append(float(out[3]))
            return out

        return optimizer, run

    monkeypatch.setattr(jtrainer, "make_supervised_finetune", recording)
    return losses


def test_pipeline_matches_jax_pipeline(tmp_path, monkeypatch):
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)))
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(11), HLEN, NCLASSES, NPROTO, "linear"))
    seg_init = jax.tree.map(np.asarray, jheads.init_one_shot_segmentor(
        jax.random.PRNGKey(12), NCLASSES, 4, "XXS"))
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in outs.values():
        os.makedirs(d)
        jax_save_pytree(os.path.join(d, "swav_params.npz"), ssl)

    jax_losses = _record_jax_losses(monkeypatch)
    jpipe = JaxPipeline(out_dir=outs["jax"], model="ffhq-256",
                        segmentor="hfc_with_swav", num_test_samples=N_TEST,
                        custom=cfg)
    _evaluate_mode(jpipe)
    jpipe.segmentor_init_params = jax.tree.map(jnp.asarray, seg_init)
    jpipe.run_pipeline()

    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    _build.reset_launches()
    pipe = OneShotPipeline(out_dir=outs["torch"], model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=N_TEST,
                           custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    _evaluate_mode(pipe)
    pipe.preprocessor = pipe._build_ssl_preprocessor()  # loads swav_params.npz
    pipe.preprocessor.mean_latent = torch.from_numpy(
        np.array(jpipe.preprocessor.mean_latent))
    pipe.segmentor_init_params = seg_init
    pipe.run_pipeline()
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path
    assert pipe.preprocessor.pretrain_count == 0

    np.testing.assert_allclose(
        pipe.one_shot_train_features.numpy(),
        np.asarray(jpipe.one_shot_train_features), atol=1e-4, rtol=1e-4)
    losses = [loss for _, loss, _ in pipe.finetune_log]
    assert [e for e, _, _ in pipe.finetune_log] == [3, 6]
    assert len(jax_losses) == len(losses) == 2
    for got, want in zip(losses, jax_losses):
        assert abs(got - want) <= 1e-5 * abs(want), (losses, jax_losses)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.segmentor_params))
    tleaves = [layer[k].detach().numpy() for layer in pipe.segmentor_params
               for k in sorted(layer)]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=0)

    jt, tt = (os.path.join(outs[k], "tests") for k in ("jax", "torch"))
    jpred = np.load(os.path.join(jt, "label_predictions.npy"))
    tpred = np.load(os.path.join(tt, "label_predictions.npy"))
    assert tpred.shape == jpred.shape == (N_TEST, SIZE, SIZE)
    assert (tpred == jpred).mean() >= 0.999
    for name in ("mask_iou_results.csv", "bb_iou_results.csv"):
        jh, ji, jv = _read_csv(os.path.join(jt, name))
        th, ti, tv = _read_csv(os.path.join(tt, name))
        assert th == jh == ["", "background", "a", "b", "c"]
        assert ti == ji == [str(i) for i in range(N_TEST)]
        np.testing.assert_allclose(tv, jv, atol=1e-3, rtol=0)
    jres = np.load(os.path.join(jt, "results.npz"), allow_pickle=True)
    tres = np.load(os.path.join(tt, "results.npz"), allow_pickle=True)
    assert sorted(tres.files) == sorted(jres.files)
    assert tres["bin_iou"].dtype == object
    assert abs(pipe.mean_mask_iou - jpipe.mean_mask_iou) <= 1e-3


# ---------------------------------------------------------------------------
# (b), (c): the port alone
# ---------------------------------------------------------------------------


def _point_mapper_at(monkeypatch, cfg):
    monkeypatch.setitem(tmapper.models, "ffhq-256", cfg["model"])
    monkeypatch.setitem(tmapper.segmentors, "hfc_with_swav_ffhq", cfg["seg"])
    monkeypatch.setitem(tmapper.trainer, "supervised", cfg["trainer"])


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """One run of the pretrain CLI (SwAV pretrained, train_hfc True) on
    synthesised samples, with the mapper pointed at the tiny configs; shared
    by the tests that need its swav_params.npz."""
    from ganecdotes_torch.cli import pretrain

    d = str(tmp_path_factory.mktemp("pretrained"))
    cfg = _write_configs(d)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            _point_mapper_at(mp, cfg)
            pipe = pretrain.main(["--out_dir", os.path.join(d, "out"),
                                  "--num_test_samples", str(N_TEST),
                                  "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    return pipe, cfg


def test_pipeline_learns(pretrained):
    pipe, _ = pretrained
    tests = os.path.join(pipe.out_dir, "tests")
    for name in ("results.npz", "mask_iou_results.csv", "bb_iou_results.csv",
                 "label_predictions.npy", "iou_vs_pd_curve.png"):
        assert os.path.exists(os.path.join(tests, name)), name
    assert os.path.exists(os.path.join(pipe.out_dir, "swav_params.npz"))
    assert pipe.preprocessor.pretrain_count == 1
    preds = np.load(os.path.join(tests, "label_predictions.npy"))
    assert preds.shape == (N_TEST, SIZE, SIZE)
    baseline = _majority_class_mean_iou(pipe)
    assert pipe.mean_mask_iou > baseline, (pipe.mean_mask_iou, baseline)
    # the synthesised test set: 3 samples + the one-shot one, padded to a
    # full request of 8
    assert pipe.test_latents.shape == (N_TEST, 512)
    assert len(pipe.finetune_log) == 2 and pipe.finetune_log[-1][0] == 6


def test_swav_presaved_reload(pretrained, tmp_path):
    """evaluate.py's semantics: load swav_params.npz, never pretrain."""
    first, cfg = pretrained
    out = str(tmp_path / "reload")
    os.makedirs(out)
    params_path = os.path.join(out, "swav_params.npz")
    shutil.copy2(os.path.join(first.out_dir, "swav_params.npz"), params_path)
    mtime = os.path.getmtime(params_path)
    pipe = OneShotPipeline(out_dir=out, model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=N_TEST,
                           custom=cfg, device="cpu")
    _evaluate_mode(pipe)
    pipe.run_pipeline()
    assert pipe.preprocessor.pretrain_count == 0
    assert os.path.getmtime(params_path) == mtime
    assert pipe.mean_mask_iou > _majority_class_mean_iou(pipe)


# ---------------------------------------------------------------------------
# (d) the CLIs, and what raises
# ---------------------------------------------------------------------------


def test_evaluate_cli(pretrained, tmp_path, monkeypatch):
    from ganecdotes_torch.cli import evaluate

    first, cfg = pretrained
    _point_mapper_at(monkeypatch, cfg)
    out = str(tmp_path / "eval")
    os.makedirs(out)
    shutil.copy2(os.path.join(first.out_dir, "swav_params.npz"), out)
    pipe = evaluate.main(["--out_dir", out, "--num_test_samples", str(N_TEST),
                          "--device", "cpu"])
    assert pipe.seg_str == "hfc_with_swav_ffhq"  # the ffhq alias
    assert not pipe.seg_config.train_hfc
    assert pipe.preprocessor.pretrain_count == 0
    for name in ("results.npz", "mask_iou_results.csv", "bb_iou_results.csv"):
        assert os.path.exists(os.path.join(out, "tests", name)), name

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--out_dir", str(tmp_path / "nocard")])
    with pytest.raises(NotImplementedError, match="item 8"):
        evaluate.main(["--out_dir", out, "--device", "cpu",
                       "--export_serving", str(tmp_path / "a.ganex")])


def test_pretrain_cli(pretrained, tmp_path):
    """The pretrain CLI's run (the shared fixture): train_hfc True, SwAV
    pretrained once and saved; without a card and --device it raises."""
    from ganecdotes_torch.cli import pretrain

    pipe, _ = pretrained
    assert pipe.seg_str == "hfc_with_swav_ffhq"
    assert pipe.seg_config.train_hfc and pipe.seg_config.hfc_prep_args["train"]
    assert pipe.preprocessor.pretrain_count == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            pretrain.main(["--out_dir", str(tmp_path / "nocard")])


def test_pipeline_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OneShotPipeline(str(tmp_path / "a"), segmentor="hfc_with_swav_ffhq")
    with pytest.raises(RuntimeError, match="CUDA"):
        OneShotPipeline(str(tmp_path / "b"), segmentor="hfc_with_swav_ffhq",
                        device="cuda")


@pytest.mark.parametrize("kwargs,item", [
    (dict(segmentor="hfc_kmeans", seg_edit=("hfc_algo='hfc_kmeans'",
                                            "hfc_algo='hfc_kmeans_hier'")),
     "item 10"),
    (dict(segmentor="hfc_kmeans", seg_edit=("hier_encode=False",
                                            "hier_encode=True")), "item 10"),
    (dict(segmentor="hfc_with_simclr", projection_pt=True), "item 5"),
    (dict(model="cat-256", segmentor="hfc_with_swav_cat"), "item 9"),
    (dict(model="p-car-512", segmentor="hfc_with_swav"), "item 9"),
])
def test_what_is_not_ported_raises_with_its_roadmap_item(tmp_path, kwargs, item):
    """Configs not copied (item 9); the hierarchical k-means and the belief
    encoding in the tiny hfc_kmeans config (item 10); the reference's
    projection.pt as the only SimCLR params of an evaluate run (item 5)."""
    kwargs = dict(kwargs)
    edit, projection_pt = kwargs.pop("seg_edit", None), kwargs.pop("projection_pt", False)
    out = str(tmp_path / "o")
    if edit or projection_pt:
        body = TINY_KMEANS if edit else TINY_SIMCLR
        assert not edit or body.count(edit[0]) == 1
        cfg = _write_configs(str(tmp_path), seg=body.replace(*edit) if edit else body)
        kwargs["custom"] = cfg
    with pytest.raises(NotImplementedError, match=item):
        pipe = OneShotPipeline(out, device="cpu", **kwargs)
        open(os.path.join(out, "projection.pt"), "wb").close()
        _evaluate_mode(pipe)
        pipe.run_pipeline()


def test_online_gui_and_sample_noises_raise(tmp_path):
    cfg = _write_configs(str(tmp_path))
    pipe = OneShotPipeline(str(tmp_path / "o"), segmentor="hfc_with_swav",
                           mode="online", custom=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        pipe.run_pipeline()
    with pytest.raises(ValueError, match="offline"):
        OneShotPipeline(str(tmp_path / "p"), segmentor="hfc_with_swav",
                        custom=cfg, device="cpu").run_pipeline(
            input_latent=np.zeros(512, np.float32))
    noisy = str(tmp_path / "noisy_config.py")
    with open(cfg["model"]) as f, open(noisy, "w") as g:
        g.write(f.read() + "\nsample_noises = '/nonexistent/noises.pt'\n")
    with pytest.raises(NotImplementedError, match="item 9"):
        OneShotPipeline(str(tmp_path / "q"), segmentor="hfc_with_swav",
                        custom=dict(cfg, model=noisy), device="cpu")


def test_online_mode_with_a_fed_latent_and_noises(pretrained, tmp_path):
    """Online mode with the one-shot latent (and its noise maps) fed in: the
    whole test set stays, and the one-shot features follow the fed noise."""
    from ganecdotes_torch.models.stylegan2.generator import make_noise

    first, cfg = pretrained
    out = str(tmp_path / "online")
    os.makedirs(out)
    shutil.copy2(os.path.join(first.out_dir, "swav_params.npz"), out)
    pipe = OneShotPipeline(out, segmentor="hfc_with_swav", mode="online",
                           custom=cfg, device="cpu", num_test_samples=2)
    _evaluate_mode(pipe)
    with torch.no_grad():  # the init's noise strength is 0
        for conv in [pipe.model.conv1, *pipe.model.convs]:
            conv.noise_weight.fill_(0.3)
    latent = np.random.RandomState(3).randn(512).astype(np.float32) * 0.5
    noises = make_noise(pipe.model.meta, generator=torch.Generator().manual_seed(4))
    pipe.run_pipeline(input_latent=latent, input_noises=noises,
                      blocks_to_run=("setup",))
    assert pipe.test_latents.shape[0] == 3  # 2 + 1 synthesised, none removed
    fixed = pipe.get_image_from_latent(torch.from_numpy(latent)[None])
    assert not torch.equal(pipe.one_shot_img, fixed)
    torch.testing.assert_close(
        pipe.one_shot_img,
        pipe.get_image_from_latent(torch.from_numpy(latent)[None], noise=noises))
