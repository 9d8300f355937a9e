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
    (dict(model="church-512", segmentor="hfc_with_swav"), "no such file"),
])
def test_what_is_not_ported_raises_with_its_roadmap_item(tmp_path, kwargs, item):
    """The hierarchical k-means and the belief encoding in the tiny
    hfc_kmeans config (item 10); a model key whose config file the JAX
    package does not ship either."""
    kwargs = dict(kwargs)
    edit = kwargs.pop("seg_edit", None)
    out = str(tmp_path / "o")
    if edit:
        assert TINY_KMEANS.count(edit[0]) == 1
        kwargs["custom"] = _write_configs(str(tmp_path),
                                          seg=TINY_KMEANS.replace(*edit))
    with pytest.raises(NotImplementedError, match=item):
        pipe = OneShotPipeline(out, device="cpu", **kwargs)
        _evaluate_mode(pipe)
        pipe.run_pipeline()


def test_online_gui_and_sample_noises_raise(tmp_path):
    """Online mode without a fed latent (the GUI) raises; a fed latent in
    offline mode raises. A ``sample_noises`` path with nothing there no
    longer raises: the one-shot synthesis takes the generator's fixed
    buffers, without truncation, as the JAX pipeline does."""
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
    pipe = OneShotPipeline(str(tmp_path / "q"), segmentor="hfc_with_swav",
                           custom=dict(cfg, model=noisy), device="cpu",
                           num_test_samples=2)
    pipe.setup()
    assert pipe.one_shot_noise is None
    torch.testing.assert_close(
        pipe.one_shot_img,
        pipe.get_image_from_latent(pipe.one_shot_latent[None], truncate=False))


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


# ---------------------------------------------------------------------------
# (e) every shipped config, reference checkpoints, the fed-noise family and
#     the BagGAN generator
# ---------------------------------------------------------------------------

COPIED_CONFIGS = [("models", n) for n in (
    "afhq_256", "ffhq_256", "ffhq_256_rp_eyeg", "lsun_car_512", "lsun_cat_256",
    "lsun_church_256", "lsun_horse_256", "lsun_horse_256_rp",
    "pascal_car_512", "pascal_horse_256", "pidray_bag_256",
    "pidray_hammer_256", "pidray_handcuffs_256", "pidray_pliers_256",
    "pidray_powerbank_256", "pidray_wrench_256")] + [
    ("segmentors", n) for n in (
        "hfc_with_swav_config", "hfc_with_swav_cat_config",
        "hfc_with_swav_car_config", "hfc_with_swav_horse_config",
        "hfc_with_swav_pidray_config")]
SHIPPED_MODEL_KEYS = [k for k, p in tmapper.models.items() if os.path.exists(p)]
LEAN_HLEN_32 = 512 + 2 * 512 + 2 * 256 + 2 * 128  # the lean map's 7 levels


def _config_values(path, configs_dir):
    """A config file's attributes, with its package's configs directory in
    any string replaced by a marker (the only value allowed to differ)."""
    import types

    from ganecdotes_torch.utils.util import load_config

    def norm(v):
        if isinstance(v, str):
            return v.replace(configs_dir, "<CONFIGS_DIR>")
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(norm(x) for x in v)
        return v

    mod = load_config(path, "cfg")
    return {k: norm(v) for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("kind,name", COPIED_CONFIGS,
                         ids=[n for _, n in COPIED_CONFIGS])
def test_copied_config_equals_the_jax_config(kind, name):
    """Every copied model and segmentor config: the same attributes with the
    same values; only the package's configs directory differs (the PIDRay
    configs' ``config_path``)."""
    import ganecdotes_tpu
    import ganecdotes_torch

    ours = _config_values(
        os.path.join(ganecdotes_torch.CONFIGS_DIR, kind, name + ".py"),
        ganecdotes_torch.CONFIGS_DIR)
    want = _config_values(
        os.path.join(ganecdotes_tpu.CONFIGS_DIR, kind, name + ".py"),
        ganecdotes_tpu.CONFIGS_DIR)
    assert ours.keys() == want.keys()
    for k in want:
        assert ours[k] == want[k], k


@pytest.mark.parametrize("model", SHIPPED_MODEL_KEYS)
def test_every_shipped_model_key_constructs(tmp_path, model):
    """cli/evaluate.py takes every model key whose config ships (the JAX
    package's files, all copied) and its hfc_with_swav alias resolves to a
    shipped segmentor config; OneShotPipeline constructs (with a small
    generator carried in: no 256^2 generator on the CPU)."""
    from ganecdotes_tpu.configs import mapper as jmapper
    from ganecdotes_torch.cli import evaluate
    from ganecdotes_torch.models.stylegan2.generator import Generator

    assert len(SHIPPED_MODEL_KEYS) == 16 and len(COPIED_CONFIGS) == 21
    assert os.path.exists(jmapper.models[model])
    assert evaluate.build_parser().parse_args(["--model", model]).model == model
    seg = tmapper.resolve_method_alias("hfc_with_swav", model)
    gen = Generator(SIZE, n_mlp=2, generator=torch.Generator().manual_seed(0))
    pipe = OneShotPipeline(str(tmp_path), model=model, segmentor=seg,
                           device="cpu", gen=gen,
                           mean_latent=np.zeros((1, 512), np.float32))
    assert pipe.model is gen
    assert pipe.model_config.image_size == 256
    assert os.path.exists(pipe.configs["seg"])
    assert pipe.seg_config.hfc_prep_args["swav_args"]["hlen"] == pipe.seg_config.hlen


def _model_config(d, name, extra, cfg):
    """The tiny model config of ``cfg`` with ``extra`` lines appended."""
    p = os.path.join(d, f"{name}_config.py")
    with open(cfg["model"]) as f, open(p, "w") as g:
        g.write(f.read() + textwrap.dedent(extra))
    return dict(cfg, model=p)


def _jax_then_port(d, cfg, model="ffhq-256", carry_gen=True, edit=None):
    """The JAX pipeline's and the port's set-up on the same config: the
    port gets the JAX mean latent (and the JAX generator, with
    ``carry_gen``); ``edit(jpipe)`` runs on the JAX pipeline before both
    set-ups."""
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    jpipe = JaxPipeline(out_dir=os.path.join(d, "jax"), model=model,
                        segmentor="hfc_with_swav", num_test_samples=N_TEST,
                        custom=cfg)
    if edit is not None:
        edit(jpipe)
    jpipe.run_pipeline(blocks_to_run=("setup",))
    gen = (from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
           if carry_gen else None)
    pipe = OneShotPipeline(os.path.join(d, "torch"), model=model,
                           segmentor="hfc_with_swav", num_test_samples=N_TEST,
                           custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    pipe.setup()
    return jpipe, pipe


def _assert_one_shot_agrees(jpipe, pipe):
    from test_torch_checkpoints import GEN_TOL

    assert len(pipe.one_shot_features) == len(jpipe.one_shot_features)
    for ft, fj in zip(pipe.one_shot_features, jpipe.one_shot_features):
        assert tuple(ft.shape) == fj.shape
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **GEN_TOL)
    np.testing.assert_allclose(pipe.one_shot_img.numpy(),
                               np.asarray(jpipe.one_shot_img), **GEN_TOL)


def test_reference_checkpoint_loads_as_in_jax(tmp_path):
    """A model_path that exists loads (a rosinality {'g_ema': sd} .pt at
    narrow widths): the one-shot image and features of the JAX pipeline.
    A loaded generator draws nothing from the seed, so its pipeline's mean
    latent is that of a pipeline given the same weights."""
    from torch_reference_files import NARROW, N_MLP, rosinality_g_ema

    d = str(tmp_path)
    ckpt = os.path.join(d, "stylegan2-config-f.pt")
    sd = rosinality_g_ema(SIZE, seed=5)
    torch.save({"g_ema": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    cfg = _write_configs(d, *_samples(d))
    with open(cfg["model"]) as f:
        body = f.read()
    assert body.count("model_path = None") == 1
    with open(cfg["model"], "w") as f:
        f.write(body.replace("model_path = None", f"model_path = {ckpt!r}"))
    jpipe, pipe = _jax_then_port(d, cfg, carry_gen=False)
    assert pipe.model.conv1.bias.shape == (NARROW[4],)
    assert len(pipe.model.style) == N_MLP
    _assert_one_shot_agrees(jpipe, pipe)

    from ganecdotes_torch.models.stylegan2.convert import load_torch_checkpoint

    a = OneShotPipeline(os.path.join(d, "a"), custom=cfg, device="cpu",
                        segmentor="hfc_with_swav")
    b = OneShotPipeline(os.path.join(d, "b"), custom=cfg, device="cpu",
                        segmentor="hfc_with_swav",
                        gen=load_torch_checkpoint(ckpt, SIZE, n_mlp=N_MLP))
    assert torch.equal(a.mean_latent, b.mean_latent)


def _write_noises(d, nchw=True, seed=0):
    """Per-layer noise maps of a 32^2 generator (4, 8, 8, 16, 16, 32, 32),
    one file each: torch NCHW .pt as the reference saves them, or NHWC
    .npy."""
    noise_dir = os.path.join(d, "noises")
    os.makedirs(noise_dir)
    rng = np.random.RandomState(seed)
    for i, s in enumerate([4, 8, 8, 16, 16, 32, 32]):
        if nchw:
            torch.save(torch.from_numpy(rng.randn(1, 1, s, s).astype(np.float32)),
                       os.path.join(noise_dir, f"noise_{i}.pt"))
        else:
            np.save(os.path.join(noise_dir, f"noise_{i}.npy"),
                    rng.randn(1, s, s, 1).astype(np.float32))
    return noise_dir


def _noise_weights_one(jpipe):
    """StyleGAN2 initialises the noise strengths to 0: make noise visible."""
    jpipe.model.params["conv1"]["noise_weight"] = jnp.ones(())
    for c in jpipe.model.params["convs"]:
        c["noise_weight"] = jnp.ones(())


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw_pt", "nhwc_npy"])
def test_sample_noises_setup_matches_jax(tmp_path, nchw):
    """The p-car / p-horse family (tests/test_pipeline.py:442's case): the
    per-layer noises at ``sample_noises`` reach the one-shot synthesis,
    which skips truncation; the same one-shot image and features as the JAX
    pipeline with the same weights and noises."""
    d = str(tmp_path)
    noise_dir = _write_noises(d, nchw)
    cfg = _model_config(d, "noisy", f"\nsample_noises = {noise_dir!r}\n",
                        _write_configs(d, *_samples(d)))
    jpipe, pipe = _jax_then_port(d, cfg, edit=_noise_weights_one)
    assert [tuple(n.shape) for n in pipe.one_shot_noise] == [
        (1, s, s, 1) for s in (4, 8, 8, 16, 16, 32, 32)]
    _assert_one_shot_agrees(jpipe, pipe)
    w = pipe.one_shot_latent[None]
    torch.testing.assert_close(pipe.one_shot_img, pipe.get_image_from_latent(
        w, noise=pipe.one_shot_noise, truncate=False), atol=0, rtol=0)
    assert not torch.allclose(pipe.one_shot_img, pipe.get_image_from_latent(
        w, noise=pipe.one_shot_noise))  # truncated: another image
    assert not torch.allclose(pipe.one_shot_img, pipe.get_image_from_latent(
        w, truncate=False))  # the fixed buffers: another image


def test_p_car_labels_are_padded_as_in_jax(tmp_path):
    """LSUN car labels (384 x 512) padded to 512^2 rows 64..448, the JAX
    pipeline's labels and one-shot label."""
    d = str(tmp_path)
    lat, _ = _samples(d)
    rng = np.random.RandomState(4)
    lbl = os.path.join(d, "car_labels.npy")
    np.save(lbl, rng.randint(0, 4, (N_TEST + 1, 384, 512)).astype(np.int64))
    noise_dir = _write_noises(d)
    cfg = _model_config(d, "car", f"\nsample_noises = {noise_dir!r}\n",
                        _write_configs(d, lat, lbl))
    jpipe, pipe = _jax_then_port(d, cfg, model="p-car-512")
    assert pipe.test_labels.shape == (N_TEST, 512, 512)
    np.testing.assert_array_equal(pipe.test_labels, np.asarray(jpipe.test_labels))
    np.testing.assert_array_equal(pipe.one_shot_label.numpy(),
                                  np.asarray(jpipe.one_shot_label))
    assert not pipe.test_labels[:, :64].any() and not pipe.test_labels[:, 448:].any()
    _assert_one_shot_agrees(jpipe, pipe)


def _baggan_configs(d, cfg, res2chlmap=None, ckpt_dir=None):
    """A tiny BagGAN model config and its run config: ``checkpoint_dir`` and,
    where given, a top-level ``res2chlmap`` (the shipped one has none)."""
    ckpt_dir = ckpt_dir or os.path.join(d, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    run = os.path.join(d, "run_config.py")
    with open(run, "w") as f:
        f.write(f"checkpoint_dir = {ckpt_dir!r}\n")
        if res2chlmap is not None:
            f.write(f"res2chlmap = {res2chlmap!r}\n")
    cfg = _model_config(d, "baggan", f"\nconfig_path = {run!r}\n", cfg)
    with open(cfg["model"]) as f:
        body = f.read().replace("is_baggan = False", "is_baggan = True")
    with open(cfg["model"], "w") as f:
        f.write(body)
    return cfg, ckpt_dir


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_baggan_generator_loads_as_in_jax(tmp_path, fmt):
    """``is_baggan`` with a checkpoint in the run config's checkpoint_dir:
    the trainers' ``latest_net_G.npz`` or a reference ``latest_net_G.pth``
    (the lean widths; 'latest' ranks above an epoch's file). The one-shot
    image and features of the JAX pipeline; the widths are the file's."""
    from ganecdotes_torch.models.baggan import convert as tbag
    from ganecdotes_torch.utils.serialization import save_pytree
    from test_torch_checkpoints import baggan_state

    d = str(tmp_path)
    cfg, ckpt_dir = _baggan_configs(d, _write_configs(d, *_samples(d)))
    lean = tbag.BAGGAN_RES_TO_CHANNEL_MAP
    for stem, seed in (("9", 1), ("latest", 2)):
        sd = baggan_state(SIZE, lean, seed=seed)
        path = os.path.join(ckpt_dir, f"{stem}_net_G.{fmt}")
        if fmt == "npz":
            save_pytree(path, tbag.baggan_generator_tree(sd, SIZE))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jpipe, pipe = _jax_then_port(d, cfg, carry_gen=False)
    assert [c.bias.shape[0] for c in pipe.model.convs] == [
        lean[r] for r in (8, 8, 16, 16, 32, 32)]
    want = tbag.baggan_generator_tree(baggan_state(SIZE, lean, seed=2), SIZE)
    np.testing.assert_array_equal(pipe.model.input.detach().numpy(), want["input"])
    _assert_one_shot_agrees(jpipe, pipe)


def test_pidray_run_config_without_res2chlmap_truncates_the_projection(tmp_path):
    """The PIDRay width question. The SwAV pidray config's hlen is the lean
    map's sum (2528 at 256^2, LEAN_HLEN_32 here), but the shipped BagGAN run
    config sets no res2chlmap, so a generator initialised at random has the
    rosinality widths (5376 at 256^2). Neither package fails: the
    projection takes the first hlen channels of the concat (the reference's
    [:hlen] slice), so the finer levels never reach it. The port does what
    the JAX package does; a run config with res2chlmap = "baggan" (or a
    lean checkpoint) gives the widths hlen expects."""
    from ganecdotes_tpu.selfsup import swav as jswav
    from ganecdotes_torch.models.stylegan2.convert import from_jax_params
    from ganecdotes_torch.selfsup.embed import pixel_feature_maps
    from ganecdotes_torch.selfsup.swav import swav_predict_from_features

    d = str(tmp_path)
    cfg, _ = _baggan_configs(d, _write_configs(d, *_samples(d)))
    jpipe, pipe = _jax_then_port(d, cfg)
    widths = [int(f.shape[-1]) for f in pipe.one_shot_features]
    assert widths == [512] * 7 and sum(widths) == 3584 > LEAN_HLEN_32
    assert [int(f.shape[-1]) for f in jpipe.one_shot_features] == widths
    ssl = jswav.init_swav_params(jax.random.PRNGKey(3), LEAN_HLEN_32,
                                 NCLASSES, NPROTO, "linear")
    want = jswav.swav_predict_from_features(
        ssl, jpipe.one_shot_features, LEAN_HLEN_32, NCLASSES, "linear",
        "nearest")
    tssl = from_jax_params(jax.tree.map(np.asarray, ssl))
    feats = pipe.one_shot_features
    got = swav_predict_from_features(tssl, feats, LEAN_HLEN_32, NCLASSES,
                                     "linear", "nearest")
    assert got.shape == (1, SIZE, SIZE, NCLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the channels past hlen (half of the 5th level, all of the 6th and
    # 7th) do not reach it: the concat's first hlen channels
    w0 = tssl["projection"][0]["weight"]
    sliced = pixel_feature_maps(feats)[..., :LEAN_HLEN_32] @ w0
    torch.testing.assert_close(got, sliced, atol=1e-4, rtol=1e-4)
    cut = [f.clone() for f in feats]
    cut[4][..., LEAN_HLEN_32 - 2048:] = 0
    cut[5].zero_(), cut[6].zero_()
    torch.testing.assert_close(
        swav_predict_from_features(tssl, cut, LEAN_HLEN_32, NCLASSES,
                                   "linear", "nearest"), got, atol=0, rtol=0)

    cfg, _ = _baggan_configs(os.path.join(d, "lean"),
                             _write_configs(d, *_samples(d)), "baggan")
    lean = OneShotPipeline(os.path.join(d, "lean_out"), custom=cfg,
                           device="cpu", segmentor="hfc_with_swav",
                           num_test_samples=N_TEST)
    lean.setup()
    assert sum(int(f.shape[-1]) for f in lean.one_shot_features) == LEAN_HLEN_32


def test_simclr_pipeline_imports_the_reference_projection(tmp_path):
    """The reference's projection.pt as the only SimCLR params of an
    evaluate run: imported as the JAX package imports it, never
    pretrained, and the fine-tune runs on its features."""
    from ganecdotes_tpu.selfsup.simclr import import_torch_simclr_projection

    d = str(tmp_path)
    cfg = _write_configs(d, *_samples(d), seg=TINY_SIMCLR)
    out = os.path.join(d, "o")
    os.makedirs(out)
    torch.manual_seed(0)
    torch.save(torch.nn.Sequential(
        torch.nn.Linear(HLEN, NCLASSES, bias=False),
        torch.nn.BatchNorm1d(NCLASSES), torch.nn.LeakyReLU(inplace=True),
        torch.nn.Linear(NCLASSES, NCLASSES, bias=False)),
        os.path.join(out, "projection.pt"))
    pipe = OneShotPipeline(out, segmentor="hfc_with_simclr", custom=cfg,
                           device="cpu", num_test_samples=N_TEST)
    _evaluate_mode(pipe)
    pipe.run_pipeline(blocks_to_run=("setup", "train"))
    assert pipe.preprocessor.pretrain_count == 0
    want = import_torch_simclr_projection(os.path.join(out, "projection.pt"))
    for k in ("lin1", "lin2"):
        np.testing.assert_array_equal(pipe.preprocessor.params[k]["weight"].numpy(),
                                      np.asarray(want[k]["weight"]))
    assert pipe.one_shot_train_features.shape == (1, SIZE, SIZE, NCLASSES)
    assert np.isfinite(pipe.finetune_log[-1][1])


def test_labels_past_the_heads_outputs_raise_where_jax_reports_nan(
        tmp_path, monkeypatch):
    """The XXS head outputs 12 channels whatever the class count (the
    reference's zip-truncation quirk), so a model with more classes (p-horse
    34, p-car 60 under the generic hfc_with_swav config) gives one-shot
    labels past its outputs. The reference's cross entropy refuses them;
    the JAX package's reports a NaN loss and trains on the other pixels;
    the port raises before the fine-tune, naming the head."""
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    d = str(tmp_path)
    cfg = _write_configs(d)
    with open(cfg["model"]) as f:
        body = f.read()
    with open(cfg["model"], "w") as f:
        f.write(body + "\nclasses = [f'c{i}' for i in range(16)]\n")
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(11), HLEN, NCLASSES, NPROTO, "linear"))
    outs = {k: os.path.join(d, k) for k in ("jax", "torch")}
    for o in outs.values():
        os.makedirs(o)
        jax_save_pytree(os.path.join(o, "swav_params.npz"), ssl)
    losses = _record_jax_losses(monkeypatch)
    jpipe = JaxPipeline(out_dir=outs["jax"], segmentor="hfc_with_swav",
                        num_test_samples=N_TEST, custom=cfg)
    _evaluate_mode(jpipe)
    jpipe.run_pipeline(blocks_to_run=("setup", "train"))
    assert int(np.asarray(jpipe.one_shot_label).max()) >= 12
    assert losses and all(np.isnan(loss) for loss in losses)

    pipe = OneShotPipeline(outs["torch"], segmentor="hfc_with_swav",
                           num_test_samples=N_TEST, custom=cfg, device="cpu")
    _evaluate_mode(pipe)
    pipe.setup()
    with pytest.raises(ValueError, match="'XXS' head outputs 12 channels"):
        pipe.run_trainer()
