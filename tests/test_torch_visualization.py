"""The port's plot helpers (ganecdotes_torch/utils/visualization.py
``create_gif``, ``slide_show``, ``plot_boxplot``, ``plot_histogram_1d``,
``plot_image_on_axis``) held against the JAX package's on the CPU, under
matplotlib's Agg backend.

The same numpy-seeded data goes to both packages (to the port as tensors,
which it takes on any device); the files they write decode to equal pixels
and frame durations, and the axes they draw hold equal images and titles.
Every comparison is exact. Last, the port's module imports where neither
PIL nor matplotlib can be imported, as on a host that has neither.
"""

import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ganecdotes_torch.utils import visualization as tv  # noqa: E402
from ganecdotes_tpu.utils import visualization as jv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(path):
    """Every frame of an image file as an RGB array, with its duration."""
    im = Image.open(path)
    out = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        out.append((np.asarray(im.convert("RGB")), im.info.get("duration")))
    return out


def _assert_same_file(a, b):
    fa, fb = _frames(a), _frames(b)
    assert len(fa) == len(fb)
    for (pa, da), (pb, db) in zip(fa, fb):
        assert da == db
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("stride,scale,grey", [(1, None, False), (2, 1.5, True)])
def test_create_gif_matches_jax(tmp_path, stride, scale, grey):
    """Float frames (min/max normalised; greyscale ones stacked to RGB),
    every ``stride``-th, resized by ``scale``, at 4 fps."""
    rng = np.random.RandomState(0)
    frames = rng.randn(5, 12, 10, *(() if grey else (3,))).astype(np.float32)
    jv.create_gif(str(tmp_path / "jax.gif"), frames, stride=stride, scale=scale, fps=4)
    tv.create_gif(str(tmp_path / "port.gif"), torch.from_numpy(frames), stride=stride,
                  scale=scale, fps=4)
    _assert_same_file(tmp_path / "jax.gif", tmp_path / "port.gif")
    assert len(_frames(tmp_path / "port.gif")) == len(range(0, 5, stride))


@pytest.mark.parametrize("rotation", [None, 45])
def test_plot_boxplot_matches_jax(tmp_path, rotation):
    rng = np.random.RandomState(1)
    data = [rng.randn(40).astype(np.float32) * s for s in (1.0, 2.0, 0.5)]
    titles = {"xlabel": "layer", "ylabel": "IoU", "title": "per class"}
    jv.plot_boxplot(str(tmp_path / "jax.png"), (["a", "b", "c"], data), titles=titles,
                    lbl_rotation=rotation)
    tv.plot_boxplot(str(tmp_path / "port.png"),
                    (["a", "b", "c"], [torch.from_numpy(d) for d in data]),
                    titles=titles, lbl_rotation=rotation)
    _assert_same_file(tmp_path / "jax.png", tmp_path / "port.png")


@pytest.mark.parametrize("is_hist,legend", [(True, True), (False, False)])
def test_plot_histogram_1d_matches_jax(tmp_path, is_hist, legend):
    rng = np.random.RandomState(2)
    data = [rng.randn(200).astype(np.float32), rng.rand(200).astype(np.float32)]
    params = {"bins": 12} if is_hist else None
    jv.plot_histogram_1d(str(tmp_path / "jax.png"), ([0, 1], data), titles={"title": "h"},
                         legend=legend, is_hist=is_hist, hist_params=params)
    tv.plot_histogram_1d(str(tmp_path / "port.png"),
                         ([0, 1], [torch.from_numpy(d) for d in data]),
                         titles={"title": "h"}, legend=legend, is_hist=is_hist,
                         hist_params=params)
    _assert_same_file(tmp_path / "jax.png", tmp_path / "port.png")


@pytest.mark.parametrize("title", [None, "mask"])
def test_plot_image_on_axis_matches_jax(title):
    image = np.random.RandomState(3).rand(6, 7).astype(np.float32)
    fig, (ax_j, ax_t) = plt.subplots(1, 2)
    try:
        assert jv.plot_image_on_axis(ax_j, image, title=title, cmap="gray", vmin=0,
                                     vmax=1) is ax_j
        assert tv.plot_image_on_axis(ax_t, torch.from_numpy(image), title=title,
                                     cmap="gray", vmin=0, vmax=1) is ax_t
        (im_j,), (im_t,) = ax_j.get_images(), ax_t.get_images()
        np.testing.assert_array_equal(im_t.get_array(), im_j.get_array())
        assert im_t.get_clim() == im_j.get_clim() == (0, 1)
        assert im_t.get_cmap().name == im_j.get_cmap().name == "gray"
        assert ax_t.get_title() == ax_j.get_title() == (title or "")
        assert not ax_t.axison and not ax_j.axison
    finally:
        plt.close(fig)


def test_slide_show_matches_jax(monkeypatch):
    """With ``plt.pause`` recording the shown slice and title instead of
    waiting: the same slices and titles in order, and the figure closed."""
    volume = np.random.RandomState(4).rand(5, 6, 4).astype(np.float32)
    shown = []

    def pause(dt):
        ax = plt.gcf().axes[0]
        shown[-1].append((np.array(ax.get_images()[0].get_array()), ax.get_title(), dt))

    monkeypatch.setattr(plt, "pause", pause)
    for show, vol in ((jv.slide_show, volume), (tv.slide_show, torch.from_numpy(volume))):
        shown.append([])
        n_figs = len(plt.get_fignums())
        show(vol, dt=0.02, vmax=0.9, vmin=0.1)
        assert len(plt.get_fignums()) == n_figs
    want, got = shown
    assert len(got) == len(want) == volume.shape[2]
    for (a, ta, da), (b, tb, db) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ta == tb and da == db
    assert [t for _, t, _ in got] == [f"slice {k}" for k in range(4)]


def test_module_imports_without_pil_and_matplotlib():
    """In a process where importing PIL or matplotlib fails, the module
    imports and its numpy helpers run; a helper that draws raises
    ImportError when called."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'PIL.Image', 'matplotlib', 'matplotlib.pyplot', "
        "'matplotlib.colors'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from ganecdotes_torch.utils import visualization as v\n"
        "c = v.sample_label_colors(3)\n"
        "assert v.visualize_label_mask(np.array([[0, 2]]), c).shape == (1, 2, 3)\n"
        "try:\n"
        "    v.create_gif('x.gif', np.zeros((1, 2, 2)))\n"
        "except ImportError:\n"
        "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
