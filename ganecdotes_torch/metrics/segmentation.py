"""Segmentation metrics, numpy only (the port's copy of
ganecdotes_tpu/metrics/segmentation.py).

Its quirks are kept: the bounding-box fill uses exclusive-end slice bounds,
and a class's IoU is 0 when its union is empty.
"""

import numpy as np


def get_mask_iou(gt_mask, pred_mask, label):
    """Per-class mask IoU."""
    gt = (gt_mask == label).astype(np.uint8)
    pred = (pred_mask == label).astype(np.uint8)
    intersec = gt * pred
    union = gt + pred
    n_union = np.count_nonzero(union)
    return np.count_nonzero(intersec) / n_union if n_union > 0 else 0


def get_bb_iou(gt_mask, pred_mask, label):
    """Bounding-box IoU of the class masks."""
    gt = (gt_mask == label).astype(np.uint8)
    pred = (pred_mask == label).astype(np.uint8)

    if gt.max() == 0:
        return 0
    nz = gt.nonzero()
    xmin, xmax, ymin, ymax = nz[0].min(), nz[0].max(), nz[1].min(), nz[1].max()
    gt[xmin:xmax, ymin:ymax] = 1  # exclusive end, as in the reference

    if pred.max() == 0:
        return 0
    nz = pred.nonzero()
    xmin, xmax, ymin, ymax = nz[0].min(), nz[0].max(), nz[1].min(), nz[1].max()
    pred[xmin:xmax, ymin:ymax] = 1

    intersec = gt * pred
    union = gt + pred
    n_union = np.count_nonzero(union)
    return np.count_nonzero(intersec) / n_union if n_union > 0 else 0


def get_mask_dice(gt_mask, pred_mask, label):
    iou = get_mask_iou(gt_mask, pred_mask, label)
    return 2 * iou / (iou + 1)


def get_bb_dice(gt_mask, pred_mask, label):
    iou = get_bb_iou(gt_mask, pred_mask, label)
    return 2 * iou / (iou + 1)


def get_weighted_iou(gt_mask, mask_iou, classes):
    """GT-area-weighted mean of non-background class IoUs."""
    w_iou = 0.0
    h, w = gt_mask.shape
    gt_area = h * w
    for i, c in enumerate(classes):
        if c != "background":
            wt = np.count_nonzero(gt_mask == i) / gt_area
            w_iou += wt * mask_iou[c]
    return w_iou


def get_bin_iou(gt_mask, pred_mask):
    """Foreground-vs-background IoU."""
    gt = (gt_mask > 0).astype(np.uint8)
    pred = (pred_mask > 0).astype(np.uint8)
    intersec = gt * pred
    union = gt + pred
    n_union = np.count_nonzero(union)
    return np.count_nonzero(intersec) / n_union if n_union > 0 else 0


def get_pd_at_iou_threshold(iou_scores, classes, iou_thr=0.5):
    """P(detection) per class at an IoU threshold; ``iou_scores`` maps each
    class to its per-sample IoUs (a dict of arrays, or a DataFrame)."""
    return {c: (np.asarray(iou_scores[c]) > iou_thr).mean() for c in classes}


def get_iou_vs_pd_curve(iou_pd, classes, iou_inc=0.05):
    """PD-vs-IoU-threshold curves + mean curve."""
    num_vals = int(1 / iou_inc)
    vals = np.linspace(0, 1, num_vals)
    curve_points = [get_pd_at_iou_threshold(iou_pd, classes, t) for t in vals]

    out = {c: [pt[c] for pt in curve_points] for c in classes}
    mean_curve = np.zeros_like(vals)
    for c in classes:
        mean_curve += np.asarray(out[c])
    out["Mean"] = mean_curve / len(classes)
    return out


def plot_iou_vs_pd_curve(curves, classes, fname, expt_name):
    """The PD-vs-IoU-threshold curves as a PNG (matplotlib, imported here:
    nothing else of the port needs it)."""
    import matplotlib.pyplot as plt

    plt.figure()
    x_val = np.linspace(0, 1, len(curves[classes[0]]))
    for c in classes:
        if c == "Mean":
            plt.plot(x_val, curves[c], label=c, color="black")
        else:
            plt.plot(x_val, curves[c], ":", label=c)
    plt.ylim([0, 1.2])
    plt.xlim([0, 1])
    plt.grid()
    plt.legend(loc="lower left")
    plt.xlabel("IoU Threshold")
    plt.ylabel("PD")
    plt.title(f"IoU vs PD Curve, Test Class - {expt_name}")
    plt.savefig(fname)
    plt.close()
