"""Label colours, mask rendering, image collages, subplot grids, GIFs,
slide shows, box plots, histograms and image files (port of
ganecdotes_tpu/utils/visualization.py). Host-side numpy; an image or a
vector may also be a tensor on any device. PIL and matplotlib are imported
inside the functions that draw or read with them, so the module imports
without them.
"""

import os

import numpy as np


def _host(x):
    """``x`` as a numpy array (a tensor is copied off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _hsv_to_rgb(hsv):
    """(n, 3) HSV in [0, 1] -> RGB, as ``matplotlib.colors.hsv_to_rgb``."""
    h, s, v = hsv[:, 0], hsv[:, 1], hsv[:, 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = i % 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    rgb = np.zeros_like(hsv)
    for k, chans in enumerate(choices):
        m = sector == k
        for c in range(3):
            rgb[m, c] = chans[c][m]
    grey = s == 0
    rgb[grey] = v[grey, None]
    return rgb


def sample_label_colors(n=1):
    """n colours at evenly spaced hues, saturation 0.5, value 1."""
    h = np.linspace(0.0, 1.0, n)[:, np.newaxis]
    s = np.ones((n, 1)) * 0.5
    v = np.ones((n, 1)) * 1.0
    return _hsv_to_rgb(np.concatenate([h, s, v], axis=1))


def visualize_label_mask(mask, color_map):
    """Integer mask (H, W) -> RGB float32; class 0 stays black."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask.squeeze(0)
    h, w = mask.shape
    out = np.zeros((h, w, 3), dtype=np.float32)
    for i in range(1, len(color_map)):
        out[mask == i] = color_map[i]
    return out


def create_pil_collage(images, fname=None, grid=None, return_im=False):
    """Tile images (HW or HWC, uint8 or float: a float image is min/max
    normalised) into one picture, saved to ``fname`` if given."""
    from PIL import Image

    imgs = []
    for im in images:
        im = np.asarray(im)
        if im.dtype != np.uint8:
            lo, hi = im.min(), im.max()
            im = np.uint8((im - lo) / (hi - lo + 1e-12) * 255)
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        imgs.append(im)

    rows, cols = (1, len(imgs)) if grid is None else grid
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    canvas = np.zeros((rows * h, cols * w, 3), dtype=np.uint8)
    for k, im in enumerate(imgs[: rows * cols]):
        r, c = k // cols, k % cols
        canvas[r * h : r * h + im.shape[0], c * w : c * w + im.shape[1]] = im

    pil = Image.fromarray(canvas)
    if fname is not None:
        pil.save(fname)
    if return_im:
        return canvas
    return pil


def quick_imshow(nrows, ncols=1, images=None, colorbar=False, colormap="jet",
                 fname=None):
    """A grid of subplots, one image each (row-major), saved to ``fname``
    if given; returns the figure."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(nrows, ncols, squeeze=False)
    if images is not None:
        for k, im in enumerate(images[: nrows * ncols]):
            ax = axes[k // ncols][k % ncols]
            m = ax.imshow(np.asarray(im), cmap=colormap)
            ax.axis("off")
            if colorbar:
                fig.colorbar(m, ax=ax)
    if fname is not None:
        fig.savefig(fname)
    return fig


def load_image(im_path):
    """A png, jpg, tiff (PIL), npy, npz (``arr_0``) or FITS image as a
    numpy array."""
    ext = os.path.splitext(im_path)[-1].lower()
    if ext in (".png", ".jpg", ".jpeg", ".tiff"):
        from PIL import Image

        return np.asarray(Image.open(im_path))
    if ext == ".npy":
        return np.load(im_path)
    if ext == ".npz":
        return np.load(im_path)["arr_0"]
    if ext in (".fits", ".gz"):
        from ganecdotes_torch.utils.fits import read_fits_data

        return read_fits_data(im_path)
    raise ValueError(f"{im_path}: format not supported")


def create_gif(fname, input_im, stride=1, scale=None, fps=5):
    """Write frames (T, H, W[, C]) to an animated GIF: every ``stride``-th
    frame, a float frame min/max normalised, resized by ``scale``, looping,
    1000 / ``fps`` ms a frame."""
    from PIL import Image

    frames = []
    arr = _host(input_im)
    for t in range(0, arr.shape[0], stride):
        im = arr[t]
        if im.dtype != np.uint8:
            lo, hi = im.min(), im.max()
            im = np.uint8((im - lo) / (hi - lo + 1e-12) * 255)
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        pil = Image.fromarray(im)
        if scale is not None:
            pil = pil.resize((int(pil.width * scale), int(pil.height * scale)))
        frames.append(pil)
    frames[0].save(fname, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def slide_show(image, dt=0.01, vmax=None, vmin=None):
    """Show a (w, h, d) volume one depth slice after another, ``dt`` s
    each, titled ``slice k``; the figure is closed at the end."""
    import matplotlib.pyplot as plt

    image = _host(image)
    fig, ax = plt.subplots()
    im = ax.imshow(image[:, :, 0], vmax=vmax, vmin=vmin)
    for k in range(image.shape[2]):
        im.set_data(image[:, :, k])
        ax.set_title(f"slice {k}")
        plt.pause(dt)
    plt.close(fig)


def _titles(ax, titles):
    titles = titles or {}
    ax.set_xlabel(titles.get("xlabel", ""))
    ax.set_ylabel(titles.get("ylabel", ""))
    ax.set_title(titles.get("title", ""))


def plot_boxplot(fname, vectors, titles=None, lbl_rotation=None):
    """Box plot of ``vectors`` = (labels, data) saved to ``fname``;
    ``titles``: optional 'xlabel', 'ylabel', 'title'."""
    import matplotlib.pyplot as plt

    labels, data = vectors
    fig, ax = plt.subplots()
    data = _host(data) if hasattr(data, "shape") else [_host(v) for v in data]
    ax.boxplot(data, tick_labels=list(labels))
    _titles(ax, titles)
    if lbl_rotation is not None:
        plt.setp(ax.get_xticklabels(), rotation=lbl_rotation)
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)


def plot_histogram_1d(fname, vectors, titles=None, legend=True, is_hist=True,
                      hist_params=None):
    """Overlaid histograms (``is_hist``) or line plots of ``vectors`` =
    (labels, data) saved to ``fname``; ``hist_params`` go to ``ax.hist``."""
    import matplotlib.pyplot as plt

    labels, data = vectors
    hist_params = hist_params or {}
    fig, ax = plt.subplots()
    for lbl, vec in zip(labels, data):
        if is_hist:
            ax.hist(_host(vec), label=str(lbl), alpha=0.6, **hist_params)
        else:
            ax.plot(_host(vec), label=str(lbl))
    _titles(ax, titles)
    if legend:
        ax.legend()
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)


def plot_image_on_axis(ax, image, title=None, cmap=None, vmin=None, vmax=None):
    """Draw one image on the matplotlib axis ``ax``, axis off, titled if
    ``title``; returns ``ax``."""
    ax.imshow(_host(image), cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    return ax
