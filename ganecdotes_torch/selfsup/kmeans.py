"""Hidden-feature k-means clustering, flat and hierarchical, and the belief
encoding (port of ganecdotes_tpu/selfsup/kmeans.py: Lloyd's algorithm with
k-means++ seeding, the flat and the two hierarchical clusterers, the flat
and the belief encodings, the flat encoding's folded serving form and the
preprocessor).

Fit and predict stay on the device: k-means++ seeding, then a fixed number
of Lloyd iterations (an empty cluster keeps its center), best of ``n_init``
runs by inertia. The seeding keeps each point's squared distance to its
nearest chosen center as a running minimum, updated with the distance to
the newest center only: the same minimum over the same set as the JAX
package's (N, k, D) difference tensor, without it (8.6 GB a step at the
shipped config's 128^2 block). Each draw is the inverse CDF of the distances
at a uniform drawn on the CPU from a ``torch.Generator``; the chosen indices
are returned, and can be passed back in to replay a seeding.

The belief encoding (``hier_encode=True``) propagates the finest block's
one-hot cluster scores up the pyramid through belief matrices, belief[v, l]
the share of block l's cluster-l pixels whose finer block is in cluster v,
re-taking the argmax after each product; the matrices are estimated from
a batch (``region_beliefs_device``) or averaged over ``hle_samples``
syntheses and saved (``HFCPreprocessor.multi_sample_hierarchical_encoding``).

Checkpoints are the JAX package's: ``clusterer_layer_{n}.npz`` (``centers``)
per layer, ``model_stats.npz`` and ``beliefs.npz`` in ``out_dir``; where a
layer has no ``.npz``, the reference's pickled sklearn
``clusterer_layer_{n}.sav`` (``import_sklearn_clusterer``, which needs
sklearn); ``load_belief_file`` also reads the reference's beliefs layout.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from ganecdotes_torch import resolve_device
from ganecdotes_torch.models.stylegan2.generator import (
    generator_forward,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.interp import _nearest_indices, resize_nearest
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.selfsup.augmentor import (
    block_row_std,
    group_features_by_block,
    perturb_latents,
)
from ganecdotes_torch.selfsup.embed import concat_segment_fcn, narrow_first_conv
from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply

# ---------------------------------------------------------------------------
# Lloyd's algorithm
# ---------------------------------------------------------------------------


def _dist2(x, x_sq, centers):
    """||x||^2 - 2 x.c + ||c||^2, (N, K)."""
    return x_sq - 2.0 * (x @ centers.T) + (centers * centers).sum(dim=1)[None, :]


def _lloyd_refine(x, centers, max_iter=300):
    """``max_iter`` Lloyd iterations from ``centers`` -> (centers,
    assignments, inertia); an empty cluster keeps its previous center."""
    k = centers.shape[0]
    x_sq = (x * x).sum(dim=1, keepdim=True)
    for _ in range(max_iter):
        onehot = F.one_hot(_dist2(x, x_sq, centers).argmin(dim=1), k).to(x.dtype)
        counts = onehot.sum(dim=0)[:, None]
        new = (onehot.T @ x) / torch.clamp(counts, min=1.0)
        centers = torch.where(counts > 0, new, centers)
    d2 = _dist2(x, x_sq, centers)
    return centers, d2.argmin(dim=1), d2.min(dim=1).values.sum()


def kmeans_pp_init(x, k, generator=None, indices=None, draws=None):
    """k-means++ seeding of (N, D) ``x`` -> (centers (k, D), indices (k,)).

    The first center is a uniform pick, each next one a pick in proportion
    to the squared distance to the nearest center chosen so far: the
    smallest index whose cumulative distance reaches u times the total, for
    a uniform u in (0, 1] (``jax.random.choice``'s inverse CDF). ``draws``,
    (the first index, the k - 1 uniforms), replaces the draws from
    ``generator``; ``indices`` replays a seeding, drawing nothing."""
    n = x.shape[0]
    if indices is not None:
        indices = torch.as_tensor(indices, device=x.device).reshape(-1)
        chosen = [indices[:1]]
    else:
        if draws is None:
            first = torch.randint(0, n, (1,), generator=generator)
            u = 1.0 - torch.rand(max(k - 1, 0), generator=generator)
        else:
            first, u = torch.as_tensor(draws[0]).reshape(1), torch.as_tensor(draws[1])
        chosen = [first.to(x.device)]
        u = u.to(x.device, x.dtype)
    d2 = (x - x[chosen[0]]).square().sum(dim=-1)
    for i in range(1, k):
        if indices is None:
            cdf = torch.cumsum(d2 / torch.clamp(d2.sum(), min=1e-12), dim=0)
            j = torch.searchsorted(cdf, (u[i - 1] * cdf[-1]).reshape(1))
            j = torch.clamp(j, max=n - 1)
        else:
            j = indices[i : i + 1]
        chosen.append(j)
        d2 = torch.minimum(d2, (x - x[j]).square().sum(dim=-1))
    idx = torch.cat(chosen)
    return x[idx], idx


def kmeans_fit_seeded(x, k, generator=None, n_init=10, max_iter=300,
                      seeds=None):
    """Best of ``n_init`` k-means runs by inertia -> (centers, the seeding
    indices of every run). ``seeds``, a list of ``n_init`` index tensors,
    replays a fit's seedings."""
    best, best_inertia, used = None, np.inf, []
    for i in range(n_init):
        centers, idx = kmeans_pp_init(
            x, k, generator, None if seeds is None else seeds[i])
        used.append(idx)
        centers, _, inertia = _lloyd_refine(x, centers, max_iter)
        if float(inertia) < best_inertia:
            best, best_inertia = centers, float(inertia)
    return best, used


def kmeans_fit(x, k, generator=None, n_init=10, max_iter=300,
               init_centers=None):
    """Best-of-``n_init`` k-means (sklearn's default semantics) -> centers;
    with ``init_centers``, Lloyd's iterations from them only."""
    if init_centers is not None:
        return _lloyd_refine(x, init_centers[:k], max_iter)[0]
    return kmeans_fit_seeded(x, k, generator, n_init, max_iter)[0]


def _resize_labels(labels, out_size):
    """Nearest-resize an integer (B, h, w) label map to (B, out, out): a
    broadcast for integer factors, a gather otherwise."""
    b, h, w = labels.shape
    if (h, w) == (out_size, out_size):
        return labels
    if out_size % h == 0 and out_size % w == 0:
        sh, sw = out_size // h, out_size // w
        return labels[:, :, None, :, None].expand(b, h, sh, w, sw).reshape(
            b, out_size, out_size)
    ri = _nearest_indices(h, out_size, labels.device)
    ci = _nearest_indices(w, out_size, labels.device)
    return labels[:, ri][:, :, ci]


def import_sklearn_clusterer(path):
    """The reference's ``clusterer_layer_{n}.sav`` (a pickled sklearn
    ``KMeans``) -> its (k, d) float32 centers on the CPU. sklearn's
    ``predict`` is the argmin of squared distances to these centers, as
    ``kmeans_predict`` computes it.

    A ``.sav`` file is a pickle: loading one runs code from the file, so
    load only files you made or trust, as the reference does. Unpickling
    needs sklearn's classes; without sklearn this raises an ImportError
    that says so and names the ``.npz`` alternative."""
    import pickle

    with open(path, "rb") as f:
        try:
            obj = pickle.load(f)
        except ModuleNotFoundError as e:
            raise ImportError(
                f"importing {path!r} requires scikit-learn (the reference "
                "pickled an sklearn KMeans object); install sklearn or "
                f"provide a clusterer_layer_{{n}}.npz instead: {e}") from e
    return torch.from_numpy(np.asarray(obj.cluster_centers_, dtype=np.float32))


def load_belief_file(path, device=None):
    """``beliefs.npz`` -> the list of (k_prev, k_curr) float32 belief
    matrices on ``device`` (the CPU by default). Reads both layouts: one
    entry per matrix (``arr_0`` .. ``arr_N``, as ``train_hfc_model`` writes
    them), and the reference's one positional entry holding the whole list
    (ref segmentor.py:163; an object array where the shapes differ)."""
    data = np.load(path, allow_pickle=True)
    files = sorted(data.files, key=lambda s: (len(s), s))  # arr_2 < arr_10
    mats = [data[f] for f in files]
    if len(files) == 1 and (mats[0].dtype == object or mats[0].ndim == 3):
        mats = list(mats[0])
    return [torch.from_numpy(np.asarray(b, dtype=np.float32)).to(device)
            for b in mats]


def kmeans_predict(x, centers):
    """Nearest center: argmin_k (||c_k||^2 - 2 x.c_k), ||x||^2 dropped.
    bf16 features meet float32 centers in float32 (JAX's promotion)."""
    x = x.to(torch.promote_types(x.dtype, centers.dtype))
    score = (centers * centers).sum(dim=1)[None, :] - 2.0 * (x @ centers.T)
    return score.argmin(dim=1)


def kmeans_predict_parts(parts, centers):
    """``kmeans_predict`` of the channel concat of ``parts`` (N, c_i) without
    the concat: the score's product splits over the channels."""
    if sum(p.shape[-1] for p in parts) != centers.shape[1]:
        raise ValueError(
            f"parts widths {[p.shape[-1] for p in parts]} do not sum to "
            f"the centers' feature dim {centers.shape[1]}")
    score = (centers * centers).sum(dim=1)[None, :]
    off = 0
    for p in parts:
        c = p.shape[-1]
        p = p.to(torch.promote_types(p.dtype, centers.dtype))  # JAX's promotion
        score = score - 2.0 * (p @ centers[:, off : off + c].T)
        off += c
    return score.argmin(dim=1)


# ---------------------------------------------------------------------------
# the flat clusterer
# ---------------------------------------------------------------------------


class BaseHFCModel:
    """Per-layer clusterers with the reference's checkpoint layout
    (hfc_kmeans_clustering.py:11-124): ``fit`` writes one
    ``clusterer_layer_{n}.npz`` per layer and ``model_stats.npz`` (the
    per-layer feature means and standard deviations); ``ensure_centers``
    loads them. ``n_init`` and ``max_iter`` come from ``kmeans_args`` (the
    reference passes them to sklearn's KMeans), 10 and 300 by default.
    ``seed_indices`` holds the last fit's k-means++ picks per layer;
    ``replay_seeds`` (same layout) makes the next fit reuse them."""

    def __init__(self, out_dir, n_layers=6, clusters_per_layer=(), out_size=128,
                 presaved=False, logger=None, seed=42, kmeans_args=None,
                 device=None):
        self.out_dir = out_dir
        os.makedirs(self.out_dir, exist_ok=True)
        self.n_layer = n_layers
        self.clusters_per_layer = list(clusters_per_layer)
        self.out_size = out_size
        self.presaved = presaved
        self.logger = logger
        self.device = torch.device("cpu") if device is None else device
        self.generator = torch.Generator().manual_seed(seed)
        kmeans_args = dict(kmeans_args or {})
        self.n_init = kmeans_args.get("n_init", 10)
        self.max_iter = kmeans_args.get("max_iter", 300)
        self.model_fpaths = [os.path.join(out_dir, f"clusterer_layer_{n}.npz")
                             for n in range(n_layers)]
        self.sav_fpaths = [os.path.join(out_dir, f"clusterer_layer_{n}.sav")
                           for n in range(n_layers)]
        self.stats_file = os.path.join(out_dir, "model_stats.npz")
        self.means = [None] * len(self.clusters_per_layer)
        self.stds = [None] * len(self.clusters_per_layer)
        self.centers = [None] * n_layers
        self.seed_indices = [None] * n_layers
        self.replay_seeds = None
        if presaved:
            self.ensure_centers()

    def _log(self, msg):
        (self.logger.info if self.logger else print)(msg)

    def fit(self, hidden_feat):
        assert len(hidden_feat) == self.n_layer
        for n in range(self.n_layer):
            self.centers[n] = self._layerwise_fit(hidden_feat[n], n)
            self._save_centers(n)
        # per-layer widths differ: object arrays, as the JAX package saves
        means = np.empty(len(self.means), dtype=object)
        stds = np.empty(len(self.stds), dtype=object)
        for i, (m, s) in enumerate(zip(self.means, self.stds)):
            means[i] = np.asarray(m if m is not None else 0)
            stds[i] = np.asarray(s if s is not None else 0)
        np.savez_compressed(self.stats_file, means=means, stds=stds)

    def ensure_centers(self):
        """Load the saved clusterers once: ``clusterer_layer_{n}.npz``, else
        the reference's ``clusterer_layer_{n}.sav``."""
        if not any(c is None for c in self.centers):
            return
        centers = []
        for npz_fp, sav_fp in zip(self.model_fpaths, self.sav_fpaths):
            if os.path.exists(npz_fp):
                centers.append(torch.from_numpy(np.load(npz_fp)["centers"]).to(
                    self.device, torch.float32))
            elif os.path.exists(sav_fp):
                centers.append(import_sklearn_clusterer(sav_fp).to(self.device))
            else:
                raise FileNotFoundError(
                    "Models not found - use BaseHFCModel.fit() to create "
                    "model first!")
        self.centers = centers

    def predict(self, hidden_feat):
        """-> (the one-hot cluster maps (B, out, out, sum k), float32, the
        per-layer (B, 1, h, w) label maps)."""
        assert len(hidden_feat) == self.n_layer
        self.ensure_centers()
        maps, labels = [], []
        for n in range(self.n_layer):
            lab, onehot = self._layerwise_predict(hidden_feat[n], n)
            maps.append(onehot)
            labels.append(lab)
        return torch.cat(maps, dim=-1), labels

    def _layerwise_predict(self, feat, n):
        b, h, w, c = feat.shape
        labels = kmeans_predict(feat.reshape(-1, c), self.centers[n]).reshape(b, h, w)
        onehot = F.one_hot(_resize_labels(labels, self.out_size),
                           self.clusters_per_layer[n]).to(torch.float32)
        return labels[:, None], onehot

    def _seeded_fit(self, x, n):
        """Layer ``n``'s best-of-``n_init`` fit of (N, D) ``x``, its
        seedings kept in ``seed_indices`` (replayed from ``replay_seeds``)."""
        seeds = None if self.replay_seeds is None else self.replay_seeds[n]
        centers, self.seed_indices[n] = kmeans_fit_seeded(
            x, self.clusters_per_layer[n], self.generator, self.n_init,
            self.max_iter, seeds)
        return centers

    def _save_centers(self, n):
        np.savez_compressed(self.model_fpaths[n],
                            centers=self.centers[n].cpu().numpy())
        self._log(f"Fitted model for Layer {n}")

    def _layerwise_fit(self, feat, n):
        x = feat.reshape(-1, feat.shape[-1])
        self.means[n] = x.mean(dim=0).cpu().numpy()
        self.stds[n] = x.std(dim=0, unbiased=False).cpu().numpy()
        return self._seeded_fit(x, n)


class FlatKMeansHFC(BaseHFCModel):
    def __init__(self, kmeans_args, base_args, device=None):
        self.kmeans_args = dict(kmeans_args)
        super().__init__(**base_args, kmeans_args=kmeans_args, device=device)


class HierarchicalKMeansHFC(BaseHFCModel):
    """Cluster centers propagated from each block to the next finer one
    (ref hfc_kmeans_clustering.py:212-390): block 0 is fitted from k-means++
    seedings; every later block runs Lloyd's iterations only, from its
    parent's centers. Each parent cluster gives two children, both at the
    mean of every channel of the finer block's features over the parent's
    (nearest-resized) pixels, a scalar repeated across the channels, as the
    reference takes it; the twins are equal, so the second stays empty and
    keeps its center wherever the argmin's first index wins their tie."""

    def __init__(self, kmeans_args, base_args, device=None):
        self.kmeans_args = dict(kmeans_args)
        super().__init__(**base_args, kmeans_args=kmeans_args, device=device)
        self._cluster_centers = None

    def hierarchical_fit(self, hidden_feat):
        assert len(hidden_feat) == self.n_layer
        self._cluster_centers = None
        for n in range(self.n_layer):
            x = hidden_feat[n].reshape(-1, hidden_feat[n].shape[-1])
            if self._cluster_centers is None:
                self.centers[n] = self._seeded_fit(x, n)
            else:
                self.centers[n] = kmeans_fit(
                    x, self.clusters_per_layer[n], max_iter=self.max_iter,
                    init_centers=self._cluster_centers)
            if n != self.n_layer - 1:
                self._cluster_centers = self.calculate_cluster_centers(
                    hidden_feat[n], hidden_feat[n + 1],
                    kmeans_predict(x, self.centers[n]), n + 1)
            self._save_centers(n)

    def calculate_cluster_centers(self, feat_old, feat_new, labels, n):
        """Block ``n``'s initial centers, (2 k_{n-1}, C_n): per cluster of
        block n - 1, the scalar mean of block n's features over its pixels
        (0 where it has none), each row twice."""
        b, h, w, _ = feat_old.shape
        _, hn, wn, cn = feat_new.shape
        lab = resize_nearest(labels.reshape(b, h, w, 1).to(torch.float32),
                             (hn, wn)).to(torch.int64).reshape(-1)
        onehot = F.one_hot(lab, self.clusters_per_layer[n - 1]).to(feat_new.dtype)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ feat_new.reshape(-1, cn)
        mean = sums.sum(dim=1) / torch.clamp(counts * cn, min=1.0)
        centers = torch.where(counts[:, None] > 0,
                              mean[:, None] * torch.ones(1, cn, device=mean.device),
                              0.0)
        return centers.repeat_interleave(2, dim=0)


class LegacyHierarchicalKMeansHFC(BaseHFCModel):
    """The older top-down hierarchical clusterer (ref
    hfc_hier_kmeans_clustering.py:18-181): blocks are clustered from the
    finest to the coarsest, each block's features nearest-resized to its
    finer neighbour's grid and concatenated with that neighbour's one-hot
    maps (at ``out_size``) before clustering. ``hierarchical_predict``
    returns the per-block label maps at ``out_size`` (B, n_layers, out,
    out) and the channel concat of the one-hot maps, in block order."""

    def __init__(self, kmeans_args, base_args, device=None):
        self.kmeans_args = dict(kmeans_args)
        super().__init__(**base_args, kmeans_args=kmeans_args, device=device)

    def _concat_child(self, feat, child_maps):
        if child_maps is None:
            return feat
        feat = resize_nearest(feat, tuple(child_maps.shape[1:3]))
        return torch.cat([feat, child_maps], dim=-1)

    def _onehot_maps(self, labels, n):
        return F.one_hot(_resize_labels(labels, self.out_size),
                         self.clusters_per_layer[n]).to(torch.float32)

    def fit(self, hidden_feat):
        assert len(hidden_feat) == self.n_layer
        child_maps = None
        for n in range(self.n_layer - 1, -1, -1):
            feat = self._concat_child(hidden_feat[n], child_maps)
            b, h, w, c = feat.shape
            x = feat.reshape(-1, c)
            self.centers[n] = self._seeded_fit(x, n)
            labels = kmeans_predict(x, self.centers[n]).reshape(b, h, w)
            child_maps = self._onehot_maps(labels, n)
            self._save_centers(n)

    def hierarchical_predict(self, hidden_feat):
        assert len(hidden_feat) == self.n_layer
        maps, labels_out = [], []
        child_maps = None
        for n in range(self.n_layer - 1, -1, -1):
            feat = self._concat_child(hidden_feat[n], child_maps)
            b, h, w, c = feat.shape
            labels = kmeans_predict(feat.reshape(-1, c), self.centers[n]).reshape(b, h, w)
            child_maps = self._onehot_maps(labels, n)
            lab_rs = resize_nearest(labels[..., None].to(torch.float32),
                                    self.out_size).to(torch.int64)[..., 0]
            maps.append(child_maps)
            labels_out.append(lab_rs[:, None])
        return torch.cat(labels_out[::-1], dim=1), torch.cat(maps[::-1], dim=-1)


# ---------------------------------------------------------------------------
# the flat encoding and its folded serving form
# ---------------------------------------------------------------------------


def _assign(groups, centers):
    """Per-layer (B, h, w) labels; a group may be a tuple of channel parts."""
    labels = []
    for feat, c in zip(groups, centers):
        parts = feat if isinstance(feat, (tuple, list)) else (feat,)
        b, h, w, _ = parts[0].shape
        labels.append(kmeans_predict_parts(
            [p.reshape(-1, p.shape[-1]) for p in parts], c).reshape(b, h, w))
    return labels


def _dtype(groups):
    first = groups[0]
    return (first[0] if isinstance(first, (tuple, list)) else first).dtype


def hfc_predict_from_features(groups, centers, clusters_per_layer, out_size,
                              hier_encode=True, beliefs=None):
    """Grouped features -> (features (B, out, out, C) in {-1, 1}, labels)
    (ref baseline/hfc_kmeans/segmentor.py:169-230): each layer's nearest
    center and its one-hot map nearest-resized to ``out_size``.

    Flat (``hier_encode=False``): the maps' concat (C = sum k) and the
    per-layer (B, 1, h, w) labels. With ``hier_encode``: the belief
    encoding of the finest layer's map (``hierarchical_label_encoding``),
    its score maps coarsest first, and its (B, out, out) labels finest
    first (the finest layer's as (B, 1, h, w)); ``beliefs=None`` estimates
    the belief matrices from this batch."""
    dt = _dtype(groups)
    labels = _assign(groups, centers)
    maps = [F.one_hot(_resize_labels(lab, out_size), k).to(dt)
            for lab, k in zip(labels, clusters_per_layer)]
    cluster_labels = [lab[:, None] for lab in labels]
    if hier_encode:
        hier_labels, hier_preds, _ = hierarchical_label_encoding(
            cluster_labels, maps[-1], clusters_per_layer, beliefs)
        return torch.cat(hier_preds[::-1], dim=-1) * 2 - 1, hier_labels
    return torch.cat(maps, dim=-1) * 2 - 1, cluster_labels


def hfc_segment_fcn(groups, centers, clusters_per_layer, out_size, seg_params,
                    size):
    """``one_shot_segmentor_apply(seg_params, hfc_predict_from_features(...)
    [0], size)``, folded -> (logits, per-layer labels).

    Where the one-hot concat is narrow (``embed.narrow_first_conv``) and the
    head's first conv reads exactly sum k channels, the concat is built as
    one multi-hot write over the upsampled label maps; otherwise each
    layer's affine one-hot map enters ``embed.concat_segment_fcn`` at its
    native resolution, and the (B, out, out, sum k) concat never exists."""
    dt = _dtype(groups)
    labels = _assign(groups, centers)
    cluster_labels = [lab[:, None] for lab in labels]
    total = sum(clusters_per_layer[: len(groups)])
    w0 = seg_params[0]["weight"]
    if (w0.dim() == 4 and w0.shape[2] == total
            and narrow_first_conv(total, w0.shape[-1])):
        ch = torch.arange(total, device=w0.device)
        acc, off = None, 0
        for lab, k in zip(labels, clusters_per_layer):
            ind = _resize_labels(lab, out_size)[..., None] == (ch - off)
            acc = ind if acc is None else acc | ind
            off += k
        z = 2 * acc.to(dt) - 1
        return one_shot_segmentor_apply(seg_params, z, size), cluster_labels
    maps = [F.one_hot(lab, k).to(dt) * 2 - 1
            for lab, k in zip(labels, clusters_per_layer)]
    logits = concat_segment_fcn(maps, seg_params, size,
                                out_hw=(out_size, out_size))
    return logits, cluster_labels


# ---------------------------------------------------------------------------
# the belief encoding
# ---------------------------------------------------------------------------


def _region_beliefs(curr_map, prev_map, shape):
    """The belief matrix by a host loop over label values (ref :394-446,
    skimage's regionprops on a label map): belief[v, l] = |{prev == v and
    curr == l}| / |{curr == l}| for every label l > 0 present in
    ``curr_map`` (label 0 skipped, as skimage skips it); float64 numpy."""
    belief = np.zeros(shape)
    curr = np.asarray(curr_map).astype(np.int64)
    prev = np.asarray(prev_map).astype(np.int64)
    for lbl in np.unique(curr):
        if lbl == 0:
            continue
        sel = curr == lbl
        area = sel.sum()
        vals, freq = np.unique(prev[sel], return_counts=True)
        for v, f in zip(vals, freq):
            belief[v, lbl] = f / area
    return belief


def region_beliefs_device(curr_map, prev_map, shape):
    """``_region_beliefs`` on the device, (k_prev, k_curr) float32: the
    co-occurrence counts as one product of one-hot maps over the area of
    each ``curr_map`` label; column 0 and absent labels' columns zero."""
    kp, kc = shape
    c1 = F.one_hot(curr_map.reshape(-1).to(torch.int64), kc).to(torch.float32)
    p1 = F.one_hot(prev_map.reshape(-1).to(torch.int64), kp).to(torch.float32)
    counts = p1.T @ c1
    area = c1.sum(dim=0)
    belief = torch.where(area > 0, counts / torch.clamp(area, min=1.0), 0.0)
    belief[:, 0] = 0.0
    return belief


def hierarchical_label_encoding(im_labels, one_hot_label, clusters_per_layer,
                                beliefs=None):
    """Propagate the finest layer's scores up the pyramid through the
    belief matrices (ref :394-478) -> (labels, score maps, beliefs).

    ``im_labels``: the per-layer (B, 1, h, w) label maps; ``one_hot_label``:
    the finest layer's (B, H, W, k_last) scores. Each step multiplies the
    (B*H*W, k) scores by the next belief matrix, takes the argmax and
    continues from its one-hot map. ``beliefs=None`` estimates the matrices
    from these label maps (``region_beliefs_device``, each coarser map
    nearest-resized to its finer neighbour's grid)."""
    num_layers = len(im_labels)
    if beliefs is None:
        beliefs = []
        for k in range(num_layers - 2, -1, -1):
            prev = im_labels[k + 1]
            h, w = prev.shape[-2:]
            curr = resize_nearest(
                im_labels[k].to(torch.float32).permute(0, 2, 3, 1), (h, w))[..., 0]
            beliefs.append(region_beliefs_device(
                curr, prev, (clusters_per_layer[k + 1], clusters_per_layer[k])))
    ob, oh, ow, oc = one_hot_label.shape
    pred = one_hot_label.reshape(-1, oc)
    out_labels, out_preds = [im_labels[-1]], [one_hot_label]
    for k in range(num_layers - 1):
        pred = pred @ beliefs[k].to(pred.dtype)
        oc = pred.shape[-1]
        pred_im = pred.reshape(ob, oh, ow, oc)
        label_im = pred_im.argmax(dim=-1)
        pred = F.one_hot(label_im.reshape(-1), oc).to(torch.float32)
        out_labels.append(label_im)
        out_preds.append(pred_im)
    return out_labels, out_preds, beliefs


# ---------------------------------------------------------------------------
# the preprocessor
# ---------------------------------------------------------------------------


class HFCPreprocessor:
    """The k-means front end of hfc_kmeans (ref
    baseline/hfc_kmeans/segmentor.py:11-231): its own mean latent, the
    perturbed-sample fit (``train_hfc_model``: the flat clusterers, or with
    ``hfc_algo='hfc_kmeans_hier'`` the hierarchical ones, then with
    ``hier_encode`` the beliefs over ``hle_samples`` syntheses, saved to
    ``beliefs.npz``), the saved clusterers' and beliefs' load
    (``ensure_loaded``) and the one-shot features (``predict_hfc_vectors``).

    ``device=None`` runs on ``cuda`` and raises without a card. Random
    numbers (the mean latent's z, each layer's perturbation normals, the
    belief samples' z, then the clusterers' seedings, from a second
    generator seeded alike) come from ``torch.Generator``s seeded with
    ``seed``.
    """

    def __init__(self, model, model_config, perturb_args, hfc_args,
                 hfc_algo="hfc_kmeans", hier_encode=True, hle_samples=500,
                 train=True, out_dir=None, logger=None, seed=42, device=None,
                 ops=KERNELS):
        if hfc_algo not in ("hfc_kmeans", "hfc_kmeans_hier"):
            raise ValueError(f"hfc_algo={hfc_algo!r}: expected 'hfc_kmeans' "
                             "or 'hfc_kmeans_hier'")
        self.device = resolve_device(device)
        self.ops = ops
        self.model_config = model_config
        self.perturb_config = perturb_args
        self.hfc_args = hfc_args
        self.hier_encode = hier_encode
        self.hfc_algo = hfc_algo
        self.hle_samples = hle_samples
        self.out_dir = out_dir
        self.train = train
        self.logger = logger
        self.generator = torch.Generator().manual_seed(seed)
        base_args = dict(hfc_args["base_args"], out_dir=out_dir, logger=logger,
                         seed=seed)
        cls = FlatKMeansHFC if hfc_algo == "hfc_kmeans" else HierarchicalKMeansHFC
        self.hfc_model = cls(hfc_args.get("kmeans_args", {}), base_args,
                             device=self.device)
        self.belief_file = os.path.join(out_dir, "beliefs.npz")
        self.trained_beliefs = None
        self.model = model.to(self.device)
        with torch.no_grad():
            self.mean_latent = _mean_latent(
                self.model, getattr(model_config, "num_latents_for_mean", 4096),
                self.generator, ops)

    def _log(self, msg):
        (self.logger.info if self.logger else print)(msg)

    def _w_plus(self, input_latent):
        lat = torch.as_tensor(input_latent, dtype=torch.float32, device=self.device)
        if lat.dim() == 1:
            lat = lat[None]
        trunc = self.perturb_config["truncation"]
        w = self.mean_latent + trunc * (lat - self.mean_latent)
        return w[:, None, :].expand(-1, self.model.meta["n_latent"], -1)

    def _grouped_features(self, w_plus, concat=True):
        with torch.no_grad():
            _, feats = generator_forward(
                self.model, [w_plus], input_is_latent=True,
                truncation=self.perturb_config["truncation"],
                truncation_latent=self.mean_latent, ops=self.ops)
        return group_features_by_block(feats, skip_const=True, concat=concat)

    def block_features(self, input_latent, z_rands=None):
        """The clusterers' training features: for block k, block k's
        features of ``n_samples`` copies of the sample with block k's w+
        rows perturbed (ref segmentor.py:68-167). ``z_rands``, one
        (n_samples * n_latent, D) normals per block, replaces the
        perturbations' draws."""
        n_layers = self.perturb_config["n_layers"]
        n_samples = self.perturb_config["n_samples"]
        n_latent = self.model.meta["n_latent"]
        d = self.model_config.latent_dim
        w_rep = self._w_plus(input_latent).repeat(n_samples, 1, 1)
        hidden = []
        for k in range(n_layers):
            row_std = block_row_std(k, n_layers, self.perturb_config["perturb_std"],
                                    n_latent, device=self.device)
            z_rand = (torch.randn(n_samples * n_latent, d, generator=self.generator)
                      if z_rands is None else torch.as_tensor(z_rands[k]))
            with torch.no_grad():
                w_new = perturb_latents(self.model, w_rep, z_rand.to(self.device),
                                        row_std, self.ops)
            hidden.append(self._grouped_features(w_new)[k])
            self._log(f"Generated features for Layer: {k}")
        return hidden

    def fit_clusterers(self, hidden):
        """The flat or the hierarchical fit of ``block_features``."""
        if self.hfc_algo == "hfc_kmeans_hier":
            self.hfc_model.hierarchical_fit(hidden)
        else:
            self.hfc_model.fit(hidden)

    def train_hfc_model(self, input_latent, z_rands=None, hle_zs=None):
        """Fit the per-layer clusterers on ``block_features``, then with
        ``hier_encode`` estimate the beliefs over ``hle_samples`` syntheses
        (``hle_zs`` replaces their z draws) and save them; returns the
        block features."""
        hidden = self.block_features(input_latent, z_rands)
        self.fit_clusterers(hidden)
        if self.hier_encode:
            self.train_beliefs(hle_zs)
        return hidden

    def train_beliefs(self, hle_zs=None):
        """The beliefs over ``hle_samples`` syntheses (``hle_zs`` replaces
        their z draws), kept and saved to ``beliefs.npz``."""
        self.trained_beliefs = self.multi_sample_hierarchical_encoding(
            self.hle_samples, self.perturb_config["n_layers"], hle_zs)
        np.savez_compressed(self.belief_file,
                            *[b.cpu().numpy() for b in self.trained_beliefs])

    def ensure_loaded(self):
        """The saved clusterers, and with ``hier_encode`` outside training
        the saved beliefs, loaded once."""
        self.hfc_model.ensure_centers()
        if self.hier_encode and self.trained_beliefs is None and not self.train:
            self.trained_beliefs = load_belief_file(self.belief_file, self.device)

    def predict_hfc_vectors(self, input_latent):
        """(features (B, out, out, C) in {-1, 1}, labels), as
        ``hfc_predict_from_features`` gives them; without trained beliefs
        the belief encoding estimates them from this sample."""
        groups = self._grouped_features(self._w_plus(input_latent))
        n_layers = self.perturb_config["n_layers"]
        self.ensure_loaded()
        with torch.no_grad():
            return hfc_predict_from_features(
                groups[:n_layers], self.hfc_model.centers[:n_layers],
                self.hfc_model.clusters_per_layer, self.hfc_model.out_size,
                self.hier_encode, self.trained_beliefs)

    def multi_sample_hierarchical_encoding(self, n_samples, n_layers, zs=None):
        """The belief matrices of ``n_samples`` syntheses of w = style(z),
        one at a time, folded in as a running half-mix (0.5 * (a + b)), as
        the JAX package does (ref :482-545). ``zs``, (n_samples, latent_dim),
        replaces the z draws."""
        beliefs = None
        k_last = self.hfc_model.clusters_per_layer[n_layers - 1]
        for i in range(n_samples):
            z = (torch.randn(1, self.model_config.latent_dim, generator=self.generator)
                 if zs is None else torch.as_tensor(zs[i]).reshape(1, -1))
            with torch.no_grad():
                w = mapping_apply(self.model, z.to(self.device), self.ops)
            groups = self._grouped_features(self._w_plus(w))
            with torch.no_grad():
                maps, labels = self.hfc_model.predict(groups[:n_layers])
                _, _, new = hierarchical_label_encoding(
                    labels, maps[..., -k_last:], self.hfc_model.clusters_per_layer)
            beliefs = new if beliefs is None else [
                0.5 * (a + b) for a, b in zip(beliefs, new)]
        return beliefs
