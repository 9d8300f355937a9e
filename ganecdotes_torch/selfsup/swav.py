"""SwAV hidden-feature clustering (port of ganecdotes_tpu/selfsup/swav.py):
the projection at inference, and pretraining.

Each pretraining step synthesises two latent-perturbed views of a fresh
sample with the frozen generator, rotates and flips their feature pyramids,
projects ``patch_size`` picked pixels of each view, scores them against the
prototypes, computes Sinkhorn-Knopp codes as constant targets (the
``sinkhorn_knopp`` op: a CUDA kernel on the card), and takes a LARS step on
the swapped-prediction loss. The step's random numbers come in one
``SwAVDraws`` record, filled by ``draw_step_inputs`` from a
``torch.Generator``, so a test can hand the port the JAX step's draws.

Params: {"projection": [{"weight": (hlen, nclasses)}, ...],
"prototype": {"weight": (nclasses, nprototypes), "bias": (nprototypes,)}}.
"""

import math
import os
import time
from typing import List, NamedTuple

import torch
from torch.profiler import record_function

from ganecdotes_torch import resolve_device
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import (
    generator_forward,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.interp import resize_nearest
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.selfsup.augmentor import (
    perturbed_features,
    random_rotate_flip_params,
    rotate_flip_features,
)
from ganecdotes_torch.selfsup.embed import (
    _level_chunks,
    layer_channel_dims,
    project_feature_maps,
    project_gathered,
)
from ganecdotes_torch.selfsup.heads import torch_linear_init
from ganecdotes_torch.selfsup.lars import LARS, apply_updates, tree_leaves, tree_map
from ganecdotes_torch.utils.serialization import load_pytree, save_pytree


def _bn_init(n):
    return {"gamma": torch.ones(n), "beta": torch.zeros(n),
            "mean": torch.zeros(n), "var": torch.ones(n)}


def init_swav_params(hlen, nclasses, nprototypes, projn_nw="linear",
                     generator=None):
    """Projection (linear | 1-layer | 2-layer, swav_clustering.py:244-269)
    + prototype Linear(nclasses, nprototypes) (:270-271)."""
    if projn_nw in ("linear", "1-layer"):
        projection = [torch_linear_init(hlen, nclasses, False, generator)]
    elif projn_nw == "2-layer":
        projection = [
            torch_linear_init(hlen, nclasses, False, generator),
            _bn_init(nclasses),
            torch_linear_init(nclasses, nclasses, False, generator),
            _bn_init(nclasses),
        ]
    else:
        raise ValueError(f"unknown projn_nw {projn_nw}")
    prototype = torch_linear_init(nclasses, nprototypes, True, generator)
    return {"projection": projection, "prototype": prototype}


def _torch_state(path):
    """A reference ``torch.save``: a pickled module or a bare state_dict ->
    {key: float32 CPU tensor}."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach().to("cpu", torch.float32) for k, v in sd.items()}


def import_torch_swav_modules(prototypes_path, projection_path, projn_nw):
    """The reference's ``prototypes.pt`` / ``projection.pt`` (its whole
    ``nn`` modules, or bare state_dicts) -> SwAV params; torch Linear
    (out, in) weights become (in, out)."""
    proj_sd = _torch_state(projection_path)
    proto_sd = _torch_state(prototypes_path)

    def lin(sd, prefix, bias):
        p = {"weight": sd[f"{prefix}weight"].T.contiguous()}
        if bias:
            p["bias"] = sd[f"{prefix}bias"]
        return p

    def bn(sd, prefix):
        return {"gamma": sd[f"{prefix}weight"], "beta": sd[f"{prefix}bias"],
                "mean": sd[f"{prefix}running_mean"],
                "var": sd[f"{prefix}running_var"]}

    if projn_nw in ("linear", "1-layer"):
        # a bare Linear's save has no Sequential index prefix
        prefix = "0." if "0.weight" in proj_sd else ""
        projection = [lin(proj_sd, prefix, bias=False)]
    elif projn_nw == "2-layer":
        projection = [lin(proj_sd, "0.", False), bn(proj_sd, "1."),
                      lin(proj_sd, "3.", False), bn(proj_sd, "4.")]
    else:
        raise ValueError(f"unknown projn_nw {projn_nw}")
    return {"projection": projection,
            "prototype": lin(proto_sd, "", bias="bias" in proto_sd)}


def projection_tail(params, z, projn_nw, train=True, eps=1e-5):
    """Everything after the (level-decomposed) first linear layer.

    nn.LeakyReLU's default slope is 0.01. The 2-layer head's BatchNorm uses
    batch statistics in train mode.
    """
    if projn_nw == "linear":
        return z
    if projn_nw == "1-layer":
        return torch.where(z >= 0, z, 0.01 * z)
    bn1, lin2, bn2 = params["projection"][1:4]
    flat = z.reshape(-1, z.shape[-1])
    if train:
        mu, var = flat.mean(0), flat.var(0, unbiased=False)
    else:
        mu, var = bn1["mean"], bn1["var"]
    h = (flat - mu) * torch.rsqrt(var + eps) * bn1["gamma"] + bn1["beta"]
    h = torch.where(h >= 0, h, 0.01 * h)
    h = h @ lin2["weight"]
    if train:
        mu2, var2 = h.mean(0), h.var(0, unbiased=False)
    else:
        mu2, var2 = bn2["mean"], bn2["var"]
    h = (h - mu2) * torch.rsqrt(var2 + eps) * bn2["gamma"] + bn2["beta"]
    return torch.tanh(h).reshape(z.shape)


def swav_predict_from_features(ssl_params, features, hlen, nclasses,
                               projn_nw="linear", interp="nearest"):
    """Raw projection scores (B, H, W, nclasses) at full resolution; labels
    are their argmax. Only the projection is applied (no prototypes).

    The reference never calls .eval() on the projection head, so its
    BatchNorm keeps using batch statistics at predict time (train=True).
    """
    z = project_feature_maps(features, ssl_params["projection"][0]["weight"],
                             hlen=hlen, interp=interp)
    return projection_tail(ssl_params, z, projn_nw, train=True)


# ---------------------------------------------------------------------------
# sinkhorn + loss
# ---------------------------------------------------------------------------


def normalize_prototypes(params):
    """Unit L2 norm for each prototype (column of the (nclasses, nproto)
    weight), applied before each step."""
    w = params["prototype"]["weight"]
    norm = torch.linalg.vector_norm(w, dim=0, keepdim=True)
    w = w / torch.clamp(norm, min=1e-12)
    return dict(params, prototype=dict(params["prototype"], weight=w))


def sinkhorn_knopp(scores, niters, eps, r, c, ops=KERNELS):
    """Codes (B, K) for scores (B, K) with marginals r (K,) and c (B,),
    through ``ops.sinkhorn_knopp``. No gradient flows through either form:
    the codes are constant targets (the JAX step wraps them in
    stop_gradient)."""
    return ops.sinkhorn_knopp(scores.detach(), niters, eps, r, c)


def _histogram_pdf(values, nbins):
    """``jnp.histogram`` counts (equal bins over [min, max], last bin closed)
    + 1e-9, with hist[0] = hist[1], normalised.

    The bin edges are computed as ``jnp.linspace`` computes them in float32
    (start * (1 - i/n) + stop * i/n), so a value lands in the same bin as in
    the JAX package unless it lies within an ulp of an edge.
    """
    values = values.reshape(-1)
    lo, hi = values.min(), values.max()
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    step = torch.arange(nbins, dtype=values.dtype, device=values.device) / nbins
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, values, right=True)
    idx = torch.where(values == edges[-1], nbins, idx)
    counts = torch.zeros(nbins + 1, dtype=torch.float32, device=values.device)
    counts = counts.index_add(0, idx, torch.ones_like(values, dtype=torch.float32))
    hist = counts[1:] + 1e-9
    hist[0] = hist[1]
    return hist / hist.sum()


def sinkhorn_marginals(scores_shape, source_pdf, img_vals=None, device=None):
    """(r (K,), c (B,)): uniform, or histograms of ``img_vals`` for 'image'."""
    b, k = scores_shape
    if source_pdf == "image":
        return _histogram_pdf(img_vals, k), _histogram_pdf(img_vals, b)
    return (torch.ones(k, device=device) / k, torch.ones(b, device=device) / b)


def swapped_prediction_loss(p_s, p_t, q_s, q_t):
    """-(<q_s, logsoftmax p_t> + <q_t, logsoftmax p_s>) / 2, rows averaged."""
    lst = (q_s * torch.log_softmax(p_t, dim=1)).sum(dim=1).mean()
    lts = (q_t * torch.log_softmax(p_s, dim=1)).sum(dim=1).mean()
    return -0.5 * (lst + lts)


def feature_norm_map(features, hlen=None):
    """Per-pixel L2 norm (B, H, W) over the first ``hlen`` concat channels,
    level by level (exact for nearest interpolation): the 'image' pdf."""
    h = max(f.shape[1] for f in features)
    w = max(f.shape[2] for f in features)
    dims = layer_channel_dims(features)
    chunks = _level_chunks(dims, sum(dims) if hlen is None else hlen)
    acc = None
    for f, (_, use) in zip(features, chunks):
        if use == 0:
            continue
        sq = f[..., :use].square().sum(dim=-1, keepdim=True)
        sq = resize_nearest(sq, (h, w))
        acc = sq if acc is None else acc + sq
    return torch.sqrt(acc[..., 0])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_pick_fn(sampling_method, h, w, patch):
    """``draw_picks(generator)``: the flat row-major pixel indices of one
    patch iteration, drawn on the CPU.

    'random': ``patch`` pixels of a fresh permutation of the image. 'patch':
    one offset p ~ U[0, h - patch) and the patch x patch block at (p, p).
    ``patch >= h`` with 'patch' means the whole image.
    """
    npix = h * w
    if sampling_method == "patch" and patch < h:
        def draw_picks(generator):
            p = int(torch.randint(0, h - patch, (), generator=generator))
            rows = (p + torch.arange(patch)) * w
            cols = p + torch.arange(patch)
            return (rows[:, None] + cols[None, :]).reshape(-1)
    elif sampling_method == "patch":
        def draw_picks(generator):
            del generator
            return torch.arange(npix)
    else:
        def draw_picks(generator):
            return torch.randperm(npix, generator=generator)[:patch]
    return draw_picks


def make_lr_schedule(swav_args, num_samples):
    """lr as a function of the optimizer's step count: the fixed
    ``train_args['lr']``, or a linear warm-up then a cosine decay."""
    if not swav_args.get("use_scheduler", False):
        lr = swav_args["train_args"]["lr"]
        return lambda step: lr
    warmup_iters = num_samples * swav_args["warmup_epochs"]
    base, final = swav_args["base_lr"], swav_args["final_lr"]
    start = swav_args["start_warmup"]
    span = swav_args["num_epochs"] - swav_args["warmup_epochs"]

    def sched(step):
        if step < warmup_iters:
            return start + (base - start) * min(step, warmup_iters - 1) / max(
                warmup_iters - 1, 1)
        t = (step - warmup_iters) / max(span, 1)
        return final + 0.5 * (base - final) * (1 + math.cos(math.pi * t))

    return sched


class SwAVDraws(NamedTuple):
    """The random numbers of one SwAV step (what the JAX step draws from
    its key), on the CPU."""

    z: torch.Tensor  # (1, latent_dim) normals: the training sample
    layer_s: int  # perturbed block of each view
    layer_t: int
    z_rand_s: torch.Tensor  # (n_latent, latent_dim) normals of each view's
    z_rand_t: torch.Tensor  # perturbation (mapped to w by the generator)
    angle_s: float  # rotation in radians and flip of each view
    flip_s: bool
    angle_t: float
    flip_t: bool
    picks: List[torch.Tensor]  # num_patches (N,) flat pixel indices


def draw_step_inputs(generator, gen_meta, model_config, perturb_args,
                     swav_args, image_hw):
    """One step's ``SwAVDraws`` from ``generator``."""
    h, w = image_hw
    n_latent = gen_meta["n_latent"]
    d = model_config["latent_dim"]
    z = torch.randn(1, d, generator=generator)
    fixed_layer = perturb_args.get("layer_no")
    if fixed_layer is None:
        n_layers = perturb_args["n_layers"]
        layer_s = int(torch.randint(0, n_layers, (), generator=generator))
        layer_t = int(torch.randint(0, n_layers, (), generator=generator))
    else:
        layer_s = layer_t = int(fixed_layer)
    z_rand_s = torch.randn(n_latent, d, generator=generator)
    z_rand_t = torch.randn(n_latent, d, generator=generator)
    angle_s, flip_s = random_rotate_flip_params(generator)
    angle_t, flip_t = random_rotate_flip_params(generator)
    draw_picks = make_pick_fn(swav_args.get("sampling_method", "random"), h,
                              w, swav_args["patch_size"] or h * w)
    picks = [draw_picks(generator) for _ in range(swav_args["num_patches"])]
    return SwAVDraws(z, layer_s, layer_t, z_rand_s, z_rand_t, angle_s, flip_s,
                     angle_t, flip_t, picks)


def make_swav_train_step(gen_meta, model_config, perturb_args, swav_args,
                         sinkhorn_args, mean_latent_w, image_hw, ops=KERNELS):
    """(optimizer, step) with
    ``step(gen, ssl_params, opt_state, draws, it) -> (params, opt, loss)``.

    The step normalises the prototypes, then differentiates the loss with
    respect to the normalised params and applies LARS to them, as the JAX
    step does. The generator runs under ``torch.no_grad()``: the features
    carry no gradient, but the projection's backward keeps them.
    """
    if swav_args.get("add_local_loss", False):
        raise NotImplementedError("add_local_loss is not ported yet")
    h, w = image_hw
    n_latent = gen_meta["n_latent"]
    n_layers = perturb_args["n_layers"]
    perturb_std = tuple(perturb_args["perturb_std"])
    truncation = model_config["truncation"]
    hlen = swav_args["hlen"]
    projn_nw = swav_args["projn_nw"]
    temperature = swav_args["temperature"]
    num_patches = swav_args["num_patches"]
    niters, eps = sinkhorn_args["niters"], sinkhorn_args["eps"]
    source_pdf = sinkhorn_args.get("source_pdf", "uniform")
    device = mean_latent_w.device

    optimizer = LARS(
        make_lr_schedule(swav_args, swav_args["num_samples"]),
        momentum=swav_args["train_args"].get("momentum", 0.9),
        trust_coefficient=swav_args["trust_coeff"],
    )

    def scores_fn(ssl_params, feats, picks):
        with record_function("swav.projection"):
            z = project_gathered(feats, picks, (h, w),
                                 ssl_params["projection"][0]["weight"],
                                 hlen=hlen)[0]  # (N, nclasses); batch 1
            z = projection_tail(ssl_params, z, projn_nw, train=True)
            z = z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True),
                                min=1e-12)
            proto = ssl_params["prototype"]
            return z @ proto["weight"] + proto["bias"]

    def sample_inputs(gen, draws):
        """Both views' rotated and flipped feature pyramids (and their norm
        maps for the 'image' pdf) for one sample."""
        with torch.no_grad(), record_function("swav.generator"):
            w_lat = mapping_apply(gen, draws.z.to(device), ops)
            # trunc(w) repeated n_latent times, as the JAX step computes it
            w_tr = mean_latent_w + truncation * (w_lat - mean_latent_w)
            w_plus = w_tr[:, None, :].expand(-1, n_latent, -1)
            views = []
            for z_rand, layer, angle, flip in (
                    (draws.z_rand_s, draws.layer_s, draws.angle_s, draws.flip_s),
                    (draws.z_rand_t, draws.layer_t, draws.angle_t, draws.flip_t)):
                _, feats = perturbed_features(
                    gen, w_plus, z_rand.to(device), layer, n_layers,
                    perturb_std, truncation, mean_latent_w, ops)
                feats = rotate_flip_features(feats, angle, flip)
                img = feature_norm_map(feats, hlen) if source_pdf == "image" else None
                views.append((feats, img))
        return views

    def loss_fn(ssl_params, views, picks):
        (feats_s, img_s), (feats_t, img_t) = views
        total = 0.0
        for p in picks:
            p = p.to(device)
            s_s = scores_fn(ssl_params, feats_s, p)
            s_t = scores_fn(ssl_params, feats_t, p)
            r_s, c_s = sinkhorn_marginals(s_s.shape, source_pdf, img_s, device)
            r_t, c_t = sinkhorn_marginals(s_t.shape, source_pdf, img_t, device)
            with record_function("swav.sinkhorn"):
                q_s = sinkhorn_knopp(s_s, niters, eps, r_s, c_s, ops)
                q_t = sinkhorn_knopp(s_t, niters, eps, r_t, c_t, ops)
            total = total + swapped_prediction_loss(
                s_s / temperature, s_t / temperature, q_s, q_t)
        return total / num_patches

    def step(gen, ssl_params, opt_state, draws, it):
        del it
        ssl_params = normalize_prototypes(ssl_params)
        views = sample_inputs(gen, draws)
        params = tree_map(lambda t: t.detach().requires_grad_(True), ssl_params)
        leaves = tree_leaves(params)
        loss = loss_fn(params, views, draws.picks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(grads), params)
        with torch.no_grad(), record_function("swav.lars"):
            updates, opt_state = optimizer.update(grads, opt_state, ssl_params)
            return apply_updates(ssl_params, updates), opt_state, loss.detach()

    return optimizer, step


# ---------------------------------------------------------------------------
# orchestrating class
# ---------------------------------------------------------------------------


class SwAVClustering:
    """The SwAV 'preprocessor' of hfc_with_swav: ``preprocess``/``pretrain``/
    ``predict_swav_codes`` over a port ``Generator`` (``model``), saving and
    loading ``swav_params.npz`` in ``out_dir`` (the JAX package's format);
    with ``train`` False and no such file it imports the reference's
    ``prototypes.pt`` and ``projection.pt`` from there.

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. Random numbers (the mean
    latent's z, the params' init, each step's draws) come from one
    ``torch.Generator`` seeded with ``seed``. ``ops`` is ``KERNELS`` or
    ``PLAIN``. With ``record_loss_history`` each epoch appends its last loss
    to ``loss_history`` and the host-clock seconds since the loop began to
    ``epoch_seconds`` (each a device sync).
    """

    def __init__(self, model, model_config, perturb_args, swav_args,
                 sinkhorn_args, logger=None, train=True, out_dir=None,
                 device=None, tb=None, layer_hf_dim=None, seed=42,
                 ops=KERNELS):
        del layer_hf_dim  # in hfc_prep_args; unused, as in the JAX package
        self.device = resolve_device(device)
        self.ops = ops
        self.record_loss_history = False
        self.loss_history = []
        self.epoch_seconds = []
        self.pretrain_count = 0
        self.model_config = model_config
        self.perturb_args = perturb_args
        self.swav_args = swav_args
        self.sinkhorn_args = sinkhorn_args
        self.logger = logger
        self.train = train
        self.out_dir = out_dir
        self.writer = tb
        self.generator = torch.Generator().manual_seed(seed)

        self.nclasses = swav_args["nclasses"]
        self.nprototypes = swav_args["nprototypes"]

        if out_dir is not None:
            os.makedirs(os.path.join(out_dir, "swav"), exist_ok=True)
            self.params_file = os.path.join(out_dir, "swav_params.npz")
        else:
            self.params_file = None

        self.model = model.to(self.device)
        with torch.no_grad():
            self.mean_latent = _mean_latent(
                self.model, getattr(model_config, "num_latents_for_mean", 4096),
                self.generator, ops)
        self.truncation = model_config.truncation

        self.ssl_params = None
        if not self.train and self.params_file and os.path.exists(self.params_file):
            self.ssl_params = from_jax_params(load_pytree(self.params_file),
                                              self.device)
        elif not self.train and out_dir is not None and all(
                os.path.exists(os.path.join(out_dir, f))
                for f in ("prototypes.pt", "projection.pt")):
            # the reference's artifacts (its torch.save'd modules)
            self.ssl_params = from_jax_params(import_torch_swav_modules(
                os.path.join(out_dir, "prototypes.pt"),
                os.path.join(out_dir, "projection.pt"),
                swav_args["projn_nw"]), self.device)
            if self.logger:
                self.logger.info("Imported reference SwAV modules "
                                 "(prototypes.pt/projection.pt)")
        elif not self.train and self.logger:
            self.logger.info("SwAV params not found - pretraining ...")

        self._image_hw = (model_config.image_size, model_config.image_size)

    def _model_config_dict(self):
        return {"truncation": self.truncation,
                "latent_dim": self.model_config.latent_dim}

    def preprocess(self, input_latent):
        """Train (or lazily load) the SSL embedding."""
        if self.train or self.ssl_params is None:
            self.pretrain(input_latent)

    def pretrain(self, input_latent=None):
        del input_latent  # placeholder in the reference too
        sa = self.swav_args
        for opt in ("checkpoint_every", "plot_test_images"):
            if sa.get(opt):
                raise NotImplementedError(f"swav_args[{opt!r}] is not ported yet")
        if (sa.get("data_parallel", False) and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError("data_parallel over more than one card "
                                      "is not ported yet")
        self.pretrain_count += 1
        self.ssl_params = from_jax_params(init_swav_params(
            sa["hlen"], sa["nclasses"], sa["nprototypes"], sa["projn_nw"],
            generator=self.generator), self.device)
        mc = self._model_config_dict()
        optimizer, step = make_swav_train_step(
            self.model.meta, mc, self.perturb_args, sa, self.sinkhorn_args,
            self.mean_latent, self._image_hw, self.ops)
        opt_state = optimizer.init(self.ssl_params)

        num_epochs, num_samples = sa["num_epochs"], sa["num_samples"]
        t0 = time.perf_counter()
        it = 0
        for e in range(num_epochs):
            for _ in range(num_samples):
                draws = draw_step_inputs(self.generator, self.model.meta, mc,
                                         self.perturb_args, sa, self._image_hw)
                self.ssl_params, opt_state, loss = step(
                    self.model, self.ssl_params, opt_state, draws, it)
                it += 1
            if self.record_loss_history:
                self.loss_history.append(float(loss))
                self.epoch_seconds.append(time.perf_counter() - t0)
            if e % sa.get("epoch_print_freq", 5) == 0:
                if self.logger:
                    self.logger.info(
                        f" E:{e}\t|\tLoss: {float(loss):.03f} \t|"
                        f"\tT: {time.perf_counter() - t0:.03f}")
                if self.writer is not None:
                    self.writer.add_scalar("swav/loss", float(loss), e)

        if self.logger:
            self.logger.info("Finished pretraining - Saving swav params")
        if self.params_file:
            save_pytree(self.params_file, self.ssl_params)

    def predict_swav_codes(self, input_latent, input_is_latent=True):
        """(NHWC projection scores, their argmax labels) for a latent."""
        z = torch.as_tensor(input_latent, dtype=torch.float32, device=self.device)
        if z.dim() == 1:
            z = z[None]
        with torch.no_grad():
            _, feats = generator_forward(
                self.model, [z], input_is_latent=input_is_latent,
                truncation=self.truncation, truncation_latent=self.mean_latent,
                ops=self.ops)
            preds = swav_predict_from_features(
                self.ssl_params, feats, self.swav_args["hlen"], self.nclasses,
                self.swav_args["projn_nw"],
                self.swav_args.get("hf_interp", "nearest"))
        return preds, preds.argmax(dim=-1)
