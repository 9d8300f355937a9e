"""Label colours, mask rendering, image collages, subplot grids and image
files (port of ganecdotes_tpu/utils/visualization.py
``sample_label_colors``, ``visualize_label_mask``, ``create_pil_collage``,
``quick_imshow`` and ``load_image``). Host-side numpy; PIL and matplotlib
are imported inside the functions that draw or read with them, so nothing
else needs them.
"""

import os

import numpy as np


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
