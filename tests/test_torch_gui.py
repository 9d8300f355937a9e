"""The port's labelling GUI (gui/labeller.py, gui/interactive_labeller.py),
its online-mode set-up and its CLI (cli/gui.py), held against the JAX
package on the CPU, headless (matplotlib under Agg).

The painter's labels are bit-equal to JAX's: both rasterise with cv2. The
interactive session runs on the tiny pipeline of tests/test_torch_pipeline.py
beside JAX's ``InteractiveLabellerGUI``: the same latent and label files,
``swav_params.npz``, generator, mean latents and head init, the same
polygon, and the same fed z for Regenerate (JAX's threefry stream and
torch's generator never agree). Tolerances: the grid's images within 1e-4
absolute (float32 syntheses summed in other orders), its mask colours
equal on at least 99.9% of pixels (tests/test_torch_pipeline.py's label
gate).
"""

import os

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ganecdotes_tpu.gui import labeller as jlab  # noqa: E402
from ganecdotes_tpu.selfsup import heads as jheads  # noqa: E402
from ganecdotes_tpu.selfsup import swav as jswav  # noqa: E402
from ganecdotes_tpu.utils.serialization import (  # noqa: E402
    save_pytree as jax_save_pytree,
)
from ganecdotes_torch.configs import mapper as tmapper  # noqa: E402
from ganecdotes_torch.gui import labeller as tlab  # noqa: E402
from ganecdotes_torch.gui.interactive_labeller import (  # noqa: E402
    InteractiveLabellerGUI,
    InteractiveSession,
)
from ganecdotes_torch.models.stylegan2.convert import (  # noqa: E402
    from_jax_generator_params,
)
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline  # noqa: E402
from test_gui import _click_button, _drag, _images, _key, _move_click  # noqa: E402
from test_torch_pipeline import (  # noqa: E402
    HLEN,
    NCLASSES,
    NPROTO,
    SIZE,
    _evaluate_mode,
    _write_configs,
)

LABEL_AGREEMENT = 0.999
N_OUT = 8  # the GUI's grid: 8 test samples, 4 rows of 2 pairs


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_open_figures():
    """Both packages' GUIs take the figure named "One Shot Labelling GUI"
    (``plt.figure`` hands back an open one of that name): each test starts
    and ends with none open, so no widget of another test, in this file or
    another one run by the same process, holds its mouse grab."""
    import matplotlib.pyplot as plt

    plt.close("all")
    yield
    plt.close("all")


# ---------------------------------------------------------------------------
# the painter
# ---------------------------------------------------------------------------


def _script(rs, size):
    """Random paint actions on a size x size canvas."""
    def pts(n):
        return [tuple(int(v) for v in rs.randint(0, size, 2)) for _ in range(n)]

    return [("polygon", pts(4)), ("next_class", None), ("brush_up", None),
            ("brush_up", None), ("lasso", pts(6)), ("polygon", pts(3)),
            ("undo", None), ("prev_class", None), ("brush_down", None),
            ("lasso", pts(5)), ("overlay", None), ("reset", None),
            ("polygon", pts(5)), ("next_class", None), ("next_class", None),
            ("lasso", pts(4))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_painter_matches_jax(seed):
    """Polygons, lasso strokes at brush size 3 (then 2), undo, reset: the
    labels bit-equal after every action, and so the overlay and the
    visualised label."""
    images = _images(2, 32)
    classes = ["background", "a", "b", "c"]
    jp, tp = jlab.MaskPainter(images, classes), tlab.MaskPainter(images, classes)
    np.testing.assert_array_equal(tp.colors, jp.colors)
    for action, arg in _script(np.random.RandomState(seed), 32):
        for p in (jp, tp):
            if action == "polygon":
                p.add_polygon(arg)
            elif action == "lasso":
                p.add_lasso(arg)
            elif action == "overlay":
                p.show_overlay = not p.show_overlay
            else:
                getattr(p, action)()
        assert tp.brush_size == jp.brush_size and tp._class == jp._class
        assert tp.get_labels().dtype == np.uint8
        np.testing.assert_array_equal(tp.get_labels(), jp.get_labels())
        np.testing.assert_array_equal(tp.get_image_label_overlay(),
                                      jp.get_image_label_overlay())
        np.testing.assert_array_equal(tp.get_visualized_label(),
                                      jp.get_visualized_label())
    assert tp.brush_size == 2
    assert tp.get_labels().sum() > 0


# ---------------------------------------------------------------------------
# the widgets, driven by synthesised events (tests/test_gui.py's, on the port)
# ---------------------------------------------------------------------------


def test_labeller_gui_synthesized_events():
    gui = tlab.OneShotLabellerGUI(_images(), ["background", "a", "b"],
                                  block=False)
    gui.fig.canvas.draw()  # transforms must be valid before synthesizing

    _key(gui, "right")
    assert gui._class == 2
    _key(gui, "up")
    _key(gui, "up")
    assert gui.brush_size == 3
    _key(gui, "down")
    assert gui.brush_size == 2

    _key(gui, "c")
    assert hasattr(gui, "lasso_selector")
    _drag(gui, [(2, 2), (2, 20), (20, 20), (20, 2)])
    n2 = (gui.get_labels()[0] == 2).sum()
    assert n2 > 0
    assert not hasattr(gui, "lasso_selector")

    _key(gui, "left")
    assert gui._class == 1
    _key(gui, "v")
    assert hasattr(gui, "poly_selector")
    verts = [(25, 25), (25, 30), (30, 30)]
    for v in verts:
        _move_click(gui, *v)
    _move_click(gui, *verts[0])
    assert (gui.get_labels()[0] == 1).sum() > 0
    assert not hasattr(gui, "poly_selector")

    _click_button(gui, gui.undo_btn)
    assert (gui.get_labels()[0] == 1).sum() == 0
    assert (gui.get_labels()[0] == 2).sum() == n2

    _key(gui, "z")
    assert gui.get_labels().sum() == 0


def test_labeller_gui_headless():
    gui = tlab.OneShotLabellerGUI(_images(), ["background", "a", "b"],
                                  block=False)
    gui._next_class(None)
    assert gui._class == 2
    assert gui.class_box.label.get_text() == "b"
    gui._process_polygon([(2, 2), (2, 10), (10, 10)])
    assert (gui.get_labels()[0] == 2).sum() > 0
    gui._overlay(None)
    assert not gui.show_overlay
    gui._next_img(None)
    assert gui.img_idx == 1 and gui.history == []
    gui._key_maps(type("E", (), {"key": "z"})())  # undo via keymap


# ---------------------------------------------------------------------------
# the interactive session against JAX's GUI
# ---------------------------------------------------------------------------


def _gui_samples(d, n=N_OUT + 1, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(n, 512) * 0.6).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    labels = np.stack([((yy + xx * (1 + i % 2) + 3 * i) // 12) % 4
                       for i in range(n)]).astype(np.int64)
    paths = os.path.join(d, "latents.npy"), os.path.join(d, "labels.npy")
    np.save(paths[0], w)
    np.save(paths[1], labels)
    return paths


def _gui_mode(pipe):
    """cli/gui.py's settings (but the tiny trainer's 6 epochs)."""
    _evaluate_mode(pipe)


def _tiles(grid, rows=N_OUT // 2):
    """(images, masks): the grid's (N_OUT, H, W, 3) image and mask tiles."""
    t = grid.reshape(rows, SIZE, 4, SIZE, 3).transpose(0, 2, 1, 3, 4)
    t = t.reshape(2 * rows * 2, SIZE, SIZE, 3)
    return t[0::2], t[1::2]


def _hold_grid(got, want, labels_too=True):
    assert got.shape == want.shape == (N_OUT // 2 * SIZE, 4 * SIZE, 3)
    assert got.dtype == np.float32
    (gi, gm), (wi, wm) = _tiles(got), _tiles(want)
    np.testing.assert_allclose(gi, wi, atol=1e-4, rtol=0)
    agree = (gm == wm).all(axis=-1).mean()
    assert agree >= LABEL_AGREEMENT, agree
    if labels_too:
        assert gm.max() > 0  # some pixel of a class > 0


def _pipelines(tmp_path):
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    cfg = _write_configs(str(tmp_path), *_gui_samples(str(tmp_path)))
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        jax.random.PRNGKey(41), HLEN, NCLASSES, NPROTO, "linear"))
    seg_init = jax.tree.map(np.asarray, jheads.init_one_shot_segmentor(
        jax.random.PRNGKey(42), NCLASSES, 4, "XXS"))
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in outs.values():
        os.makedirs(d)
        jax_save_pytree(os.path.join(d, "swav_params.npz"), ssl)
    jpipe = JaxPipeline(out_dir=outs["jax"], model="ffhq-256",
                        segmentor="hfc_with_swav", num_test_samples=N_OUT,
                        custom=cfg)
    _gui_mode(jpipe)
    jpipe.segmentor_init_params = jax.tree.map(jnp.asarray, seg_init)
    jpipe.run_pipeline(blocks_to_run=["setup"])
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    pipe = OneShotPipeline(out_dir=outs["torch"], model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=N_OUT,
                           custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    _gui_mode(pipe)
    pipe.segmentor_init_params = seg_init
    pipe.run_pipeline(blocks_to_run=["setup"])
    return jpipe, pipe


def test_interactive_session_matches_jax_gui(tmp_path):
    from ganecdotes_tpu.gui.interactive_labeller import (
        InteractiveLabellerGUI as JaxGUI,
    )

    jpipe, pipe = _pipelines(tmp_path)
    jgui = JaxGUI(one_shot_learner=jpipe, block=False)
    session = InteractiveSession(pipe)
    assert session.num_outs == jgui.num_outs == N_OUT
    np.testing.assert_array_equal(session.out_latents, jgui.out_latents)
    np.testing.assert_allclose(session.images, jgui.images, atol=1e-5, rtol=0)
    _hold_grid(session.out_grid, jgui.out_grid, labels_too=False)
    assert session.out_grid[:, SIZE : 2 * SIZE].max() == 0  # no head yet

    verts = [(2, 2), (2, 20), (20, 20), (24, 6)]
    for p in (jgui, session):
        p.add_polygon(verts)
        p.next_class()
        p.brush_up()
        p.add_lasso([(4, 28), (16, 26), (30, 30)])
    np.testing.assert_array_equal(session.get_labels(), jgui.get_labels())

    jgui._update_or_train(None)
    # the preprocessor's own mean latent, carried across as in
    # tests/test_torch_pipeline.py (the JAX one is built by its train block)
    pipe.preprocessor = pipe._build_ssl_preprocessor()
    pipe.preprocessor.mean_latent = torch.from_numpy(
        np.array(jpipe.preprocessor.mean_latent))
    grid = session.update_or_train()
    assert pipe.preprocessor.pretrain_count == 0
    np.testing.assert_array_equal(pipe.one_shot_label.numpy(),
                                  np.asarray(jpipe.one_shot_label))
    assert pipe.one_shot_label.dtype == torch.int64
    _hold_grid(grid, jgui.out_grid)

    z = np.random.RandomState(43).randn(N_OUT, 512).astype(np.float32)
    jgui.out_latents = np.asarray(jpipe.model.style(jnp.asarray(z)))
    jgui._refresh_grid(with_labels=True)
    grid = session.regenerate(z=z)
    np.testing.assert_allclose(session.out_latents, jgui.out_latents,
                               atol=1e-5, rtol=1e-5)
    _hold_grid(grid, jgui.out_grid)

    stamp = session.save()
    np.testing.assert_array_equal(
        np.load(os.path.join(session.snap_dir, f"latents_{stamp}.npy")),
        session.out_latents)


def test_interactive_gui_events_drive_the_session(tmp_path):
    """tests/test_gui.py's interactive test on the port's widgets: Regenerate,
    a polygon clicked onto the canvas, Update/Train and Save through the
    canvas event pipeline; the grid is the session's."""
    cfg = _write_configs(str(tmp_path), *_gui_samples(str(tmp_path)))
    pipe = OneShotPipeline(out_dir=str(tmp_path / "out"), model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=N_OUT,
                           custom=cfg, device="cpu")
    pipe.run_pipeline(blocks_to_run=("setup",))
    gui = InteractiveLabellerGUI(one_shot_learner=pipe, block=False)
    assert gui.out_grid.shape == (N_OUT // 2 * SIZE, 4 * SIZE, 3)
    np.testing.assert_array_equal(gui.ax_img_o.get_array(), gui.out_grid)
    gui.fig.canvas.draw()

    old = gui.out_latents.copy()
    _click_button(gui, gui.regenerate_btn)
    assert not np.allclose(gui.out_latents, old)

    assert pipe.segmentor_params is None
    _key(gui, "v")
    verts = [(2, 2), (2, 20), (20, 20)]
    for v in verts:
        _move_click(gui, *v)
    _move_click(gui, *verts[0])
    assert gui.get_labels()[0].sum() > 0

    before = gui.out_grid.copy()
    _click_button(gui, gui.train_btn)
    assert pipe.segmentor_params is not None, "Update/Train did not train"
    assert not np.allclose(gui.out_grid, before)
    np.testing.assert_array_equal(gui.ax_img_o.get_array(), gui.out_grid)
    assert gui.status.label.get_text() == "Status: Labelling"
    assert int(pipe.one_shot_label.sum()) > 0

    _click_button(gui, gui.save_btn)
    snaps = os.listdir(gui.snap_dir)
    assert any(f.startswith("snap_") and f.endswith(".png") for f in snaps)
    assert any(f.startswith("latents_") for f in snaps)


# ---------------------------------------------------------------------------
# online mode, and the CLI
# ---------------------------------------------------------------------------


def test_online_setup_without_a_fed_latent_matches_jax(tmp_path):
    from ganecdotes_tpu.pipeline.one_shot_pipeline import (
        OneShotPipeline as JaxPipeline,
    )

    cfg = _write_configs(str(tmp_path), *_gui_samples(str(tmp_path)))
    jpipe = JaxPipeline(out_dir=str(tmp_path / "jax"), model="ffhq-256",
                        segmentor="hfc_with_swav", mode="online", custom=cfg)
    jpipe.run_pipeline(blocks_to_run=["setup"])
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    pipe = OneShotPipeline(out_dir=str(tmp_path / "torch"), model="ffhq-256",
                           segmentor="hfc_with_swav", mode="online", custom=cfg,
                           device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    pipe.run_pipeline(blocks_to_run=["setup"])
    want = np.asarray(jpipe.one_shot_label)
    got = pipe.one_shot_label.numpy()
    assert got.shape == want.shape == (1, 1, SIZE, SIZE)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    np.testing.assert_allclose(pipe.labeller.images, jpipe.labeller.images,
                               atol=1e-5, rtol=0)
    assert pipe.test_latents.shape == jpipe.test_latents.shape == (N_OUT, 512)


def test_gui_cli_returns_after_setup_on_the_cpu(tmp_path, monkeypatch):
    from ganecdotes_torch.cli import gui as gui_cli

    cfg = _write_configs(str(tmp_path), *_gui_samples(str(tmp_path)))
    monkeypatch.setitem(tmapper.models, "ffhq-256", cfg["model"])
    monkeypatch.setitem(tmapper.segmentors, "hfc_with_swav", cfg["seg"])
    monkeypatch.setitem(tmapper.trainer, "supervised", cfg["trainer"])
    out = str(tmp_path / "demo")
    gui = gui_cli.main(["--out_dir", out, "--device", "cpu"])
    pipe = gui.one_shot_learner
    assert isinstance(gui, InteractiveLabellerGUI)
    assert pipe.seg_str == "hfc_with_swav" and pipe.device.type == "cpu"
    assert not pipe.seg_config.train_hfc
    assert not pipe.seg_config.hfc_prep_args["train"]
    assert pipe.trainer_config.num_epochs == gui_cli.FINETUNE_EPOCHS == 100
    assert pipe.segmentor_params is None  # set-up only
    assert gui.out_grid.shape == (N_OUT // 2 * SIZE, 4 * SIZE, 3)
    assert os.path.isdir(os.path.join(out, "snaps"))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gui_cli.main(["--out_dir", str(tmp_path / "nocard")])
