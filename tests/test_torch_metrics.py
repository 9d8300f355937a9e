"""The port's segmentation metrics and visualisation helpers held against
the JAX package's (numpy on both sides): results equal.

The masks are seeded; some classes are absent from the ground truth, the
prediction or both, so the empty-union and empty-box branches run.
"""

import numpy as np
import pytest

from ganecdotes_tpu.metrics import segmentation as jm
from ganecdotes_tpu.utils import visualization as jv
from ganecdotes_torch.metrics import segmentation as tm
from ganecdotes_torch.utils import visualization as tv

CLASSES = ["background", "a", "b", "c", "d", "e"]


def _masks(seed):
    rng = np.random.RandomState(seed)
    # blobs of classes 0..3 only: 4 and 5 never occur in the ground truth
    gt = np.zeros((24, 20), dtype=np.int64)
    for k in range(1, 4):
        y, x = rng.randint(0, 18, 2)
        gt[y : y + rng.randint(2, 7), x : x + rng.randint(2, 7)] = k
    pred = gt.copy()
    flip = rng.rand(*gt.shape) < 0.2
    pred[flip] = rng.randint(0, 5, size=flip.sum())  # 5 is never predicted
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["get_mask_iou", "get_bb_iou", "get_mask_dice",
                                "get_bb_dice"])
def test_per_class_metrics_equal_jax(fn, seed):
    gt, pred = _masks(seed)
    for k in range(len(CLASSES)):
        assert getattr(tm, fn)(gt, pred, k) == getattr(jm, fn)(gt, pred, k)
    assert tm.get_mask_iou(gt, pred, 5) == 0  # empty union


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_metrics_equal_jax(seed):
    gt, pred = _masks(seed)
    mask_iou = {c: jm.get_mask_iou(gt, pred, k) for k, c in enumerate(CLASSES)}
    assert tm.get_weighted_iou(gt, mask_iou, CLASSES) == \
        jm.get_weighted_iou(gt, mask_iou, CLASSES)
    assert tm.get_bin_iou(gt, pred) == jm.get_bin_iou(gt, pred)
    assert tm.get_bin_iou(np.zeros_like(gt), np.zeros_like(gt)) == 0


def test_pd_tables_equal_jax():
    """PD at a threshold and the PD-vs-IoU curve, from the per-class columns
    the port's pipeline keeps (a dict of arrays) and from the DataFrame the
    JAX pipeline builds."""
    import pandas as pd

    rows = [_masks(s) for s in range(6)]
    table = np.array([[tm.get_mask_iou(g, p, k) for k in range(len(CLASSES))]
                      for g, p in rows])
    columns = {c: table[:, k] for k, c in enumerate(CLASSES)}
    frame = pd.DataFrame(data=table, columns=CLASSES)
    for thr in (0.0, 0.3, 0.5, 0.9):
        assert tm.get_pd_at_iou_threshold(columns, CLASSES, thr) == \
            jm.get_pd_at_iou_threshold(frame, CLASSES, thr)
    got = tm.get_iou_vs_pd_curve(columns, CLASSES)
    want = jm.get_iou_vs_pd_curve(frame, CLASSES)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_bb_iou_keeps_the_exclusive_end_fill():
    """A one-pixel-wide class: the box fill (exclusive end) adds nothing, so
    the box IoU is the mask IoU, as in the JAX package."""
    gt = np.zeros((8, 8), dtype=np.int64)
    gt[2:6, 3] = 1
    pred = np.zeros_like(gt)
    pred[3:7, 3] = 1
    assert tm.get_bb_iou(gt, pred, 1) == jm.get_bb_iou(gt, pred, 1) == \
        tm.get_mask_iou(gt, pred, 1)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 13])
def test_label_colors_equal_jax(n):
    np.testing.assert_allclose(tv.sample_label_colors(n), jv.sample_label_colors(n),
                               atol=1e-15, rtol=0)


def test_mask_rendering_and_collage_equal_jax(tmp_path):
    gt, pred = _masks(3)
    cmap = tv.sample_label_colors(len(CLASSES))
    np.testing.assert_array_equal(tv.visualize_label_mask(pred, cmap),
                                  jv.visualize_label_mask(pred, cmap))
    img = np.random.RandomState(4).randn(24, 20, 3).astype(np.float32)
    ims = [img, np.uint8(tv.visualize_label_mask(gt, cmap) * 255), gt]
    got = tv.create_pil_collage(ims, str(tmp_path / "c.png"), grid=(2, 2),
                                return_im=True)
    want = jv.create_pil_collage(ims, grid=(2, 2), return_im=True)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "c.png").exists()
