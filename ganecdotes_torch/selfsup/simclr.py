"""SimCLR hidden-feature clustering (port of
ganecdotes_tpu/selfsup/simclr.py): the projection at inference, its folded
serving form, and pretraining.

Each pretraining step synthesises two latent-perturbed views of a fresh
sample with the frozen generator, rotates and flips their feature pyramids,
gathers ``batch_size`` picked pixels of each view, normalises each pixel's
concat feature, projects it (Linear -> BatchNorm -> LeakyReLU -> Linear) and
takes a LARS step on the NT-Xent loss over the interleaved (s, t) pairs. The
step's random numbers come in one ``SimCLRDraws`` record, filled by
``draw_step_inputs`` from a ``torch.Generator``, so a test can hand the port
the JAX step's draws.

The projection's BatchNorm always normalises with the statistics of the
batch in hand, in training and at prediction (the reference never sets eval
mode); at serving that is one image, so batched serving takes per-image
statistics and never pools samples.

Params: {"lin1": {"weight": (hlen, nclasses)}, "bn": {"gamma", "beta",
"mean", "var"}, "lin2": {"weight": (nclasses, nclasses)}}.
"""

import math
import os
import time
from typing import NamedTuple

import torch

from ganecdotes_torch import resolve_device
from ganecdotes_torch.configs.mapper import not_ported_part
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import (
    generator_forward,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.selfsup.augmentor import (
    perturbed_features,
    random_rotate_flip_params,
    rotate_flip_features,
)
from ganecdotes_torch.selfsup.embed import pixel_feature_gather, project_feature_maps
from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply
from ganecdotes_torch.selfsup.lars import LARS, apply_updates, tree_leaves, tree_map
from ganecdotes_torch.selfsup.swav import feature_norm_map
from ganecdotes_torch.utils.serialization import load_pytree, save_pytree


def init_simclr_params(hlen, nclasses, generator=None):
    """Linear(hlen, ncls, no bias) -> BN -> LeakyReLU -> Linear(ncls, ncls,
    no bias) (simclr_clustering.py:147-158), torch nn.Linear's init."""
    b1, b2 = 1.0 / math.sqrt(hlen), 1.0 / math.sqrt(nclasses)
    w1 = (torch.rand(hlen, nclasses, generator=generator) * 2 - 1) * b1
    w2 = (torch.rand(nclasses, nclasses, generator=generator) * 2 - 1) * b2
    return {
        "lin1": {"weight": w1},
        "bn": {"gamma": torch.ones(nclasses), "beta": torch.zeros(nclasses),
               "mean": torch.zeros(nclasses), "var": torch.ones(nclasses)},
        "lin2": {"weight": w2},
    }


def _bn_leaky(params, z, mu, var, eps=1e-5):
    h = (z - mu) * torch.rsqrt(var + eps) * params["bn"]["gamma"] + params["bn"]["beta"]
    return torch.where(h >= 0, h, 0.01 * h)  # nn.LeakyReLU's default slope


def simclr_projection(params, z, eps=1e-5):
    """The tail after the first Linear, z: (N, nclasses): BatchNorm with the
    batch's statistics (biased variance), LeakyReLU(0.01), lin2."""
    h = _bn_leaky(params, z, z.mean(dim=0), z.var(dim=0, unbiased=False), eps)
    return h @ params["lin2"]["weight"]


def nt_xent_loss(scores_s, scores_t, temperature):
    """NT-Xent over interleaved (s, t) pixel pairs, scores_*: (B, D).

    The 2B x 2B cosine similarities over temperature; the positives are
    (2k, 2k + 1) and (2k + 1, 2k); the denominator leaves self out (the
    diagonal set to the dtype's lowest value); the sum over rows over 2B.
    """
    b = scores_s.shape[0]
    z = torch.stack([scores_s, scores_t], dim=1).reshape(2 * b, -1)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True), min=1e-12)
    sim = (z @ z.T) / temperature
    mask = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    logits = torch.where(mask, torch.finfo(sim.dtype).min, sim)
    log_den = torch.logsumexp(logits, dim=1)
    idx = torch.arange(2 * b, device=z.device)
    pos = sim[idx, torch.where(idx % 2 == 0, idx + 1, idx - 1)]
    return -(pos - log_den).sum() / (2 * b)


class SimCLRDraws(NamedTuple):
    """The random numbers of one SimCLR step (what the JAX step draws from
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
    picks: torch.Tensor  # (batch_size,) flat pixel indices


def draw_step_inputs(generator, gen_meta, model_config, perturb_args,
                     simclr_args, image_hw):
    """One step's ``SimCLRDraws`` from ``generator``."""
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
    picks = torch.randperm(h * w, generator=generator)[: simclr_args["batch_size"]]
    return SimCLRDraws(z, layer_s, layer_t, z_rand_s, z_rand_t, angle_s, flip_s,
                       angle_t, flip_t, picks)


def make_simclr_train_step(gen_meta, model_config, perturb_args, simclr_args,
                           mean_latent_w, image_hw, ops=KERNELS):
    """(optimizer, step) with ``step(gen, params, opt_state, draws) ->
    (params, opt_state, loss)``: the loss's gradient with respect to every
    leaf (the BN's running stats get zero: the loss does not read them) and
    one LARS update, as ``optax.lars`` in the JAX step. The generator runs
    under ``torch.no_grad()``."""
    h, w = image_hw
    n_latent = gen_meta["n_latent"]
    n_layers = perturb_args["n_layers"]
    perturb_std = tuple(perturb_args["perturb_std"])
    truncation = model_config["truncation"]
    hlen = simclr_args["hlen"]
    temperature = simclr_args["temperature"]
    device = mean_latent_w.device
    optimizer = LARS(simclr_args["train_args"]["lr"],
                     momentum=simclr_args["train_args"].get("momentum", 0.9),
                     trust_coefficient=simclr_args["trust_coeff"])

    def views(gen, draws):
        with torch.no_grad():
            w_lat = mapping_apply(gen, draws.z.to(device), ops)
            w_tr = mean_latent_w + truncation * (w_lat - mean_latent_w)
            w_plus = w_tr[:, None, :].expand(-1, n_latent, -1)
            out = []
            for z_rand, layer, angle, flip in (
                    (draws.z_rand_s, draws.layer_s, draws.angle_s, draws.flip_s),
                    (draws.z_rand_t, draws.layer_t, draws.angle_t, draws.flip_t)):
                _, feats = perturbed_features(
                    gen, w_plus, z_rand.to(device), layer, n_layers,
                    perturb_std, truncation, mean_latent_w, ops)
                out.append(rotate_flip_features(feats, angle, flip))
        return out

    def scores_of(params, feats, picks):
        # each pixel's concat feature L2-normalised before the projection
        x = pixel_feature_gather(feats, picks, (h, w), hlen=hlen)[0]
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                            min=1e-12)
        return simclr_projection(params, x @ params["lin1"]["weight"])

    def step(gen, params, opt_state, draws):
        feats_s, feats_t = views(gen, draws)
        picks = draws.picks.to(device)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        loss = nt_xent_loss(scores_of(p, feats_s, picks),
                            scores_of(p, feats_t, picks), temperature)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(grads), p)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, loss.detach()

    return optimizer, step


def fold_linear_into_head(seg_params, linear_weight):
    """The head with a per-pixel linear map L composed into its first layer:
    ``conv(h @ L, W) = conv(h, W')``, W'[kh, kw, i, o] = sum_j L[i, j]
    W[kh, kw, j, o], for any dilation; a plain product for the Lin head."""
    first = seg_params[0]
    w = first["weight"]
    if w.dim() == 4:
        folded = torch.einsum("ij,hwjo->hwio", linear_weight, w)
    else:
        folded = linear_weight @ w
    return [dict(first, weight=folded)] + list(seg_params[1:])


def simclr_predict_segment(ssl_params, features, seg_params, seg_size, hlen,
                           interp="nearest"):
    """Head logits (B, H, W, C_out) of the projection, folded: each image's
    BatchNorm statistics as reductions over its own pixels (one pass,
    E[z^2] - E[z]^2, as the JAX form computes them), and ``lin2`` folded
    into the head's first layer, so the second (B, H, W, nclasses) tensor
    never exists."""
    z = project_feature_maps(features, ssl_params["lin1"]["weight"], hlen=hlen,
                             interp=interp)
    norms = feature_norm_map(features, hlen)[..., None]
    z = z * (1.0 / torch.clamp(norms, min=1e-12))
    n_px = z.shape[1] * z.shape[2]
    mu = z.sum(dim=(1, 2), keepdim=True) / n_px
    var = z.square().sum(dim=(1, 2), keepdim=True) / n_px - mu * mu
    h = _bn_leaky(ssl_params, z, mu, var)
    folded = fold_linear_into_head(seg_params, ssl_params["lin2"]["weight"])
    return one_shot_segmentor_apply(folded, h, seg_size)


def simclr_predict_from_features(params, features, hlen, interp="nearest"):
    """Projection scores (B, H, W, ncls) at full resolution (ref
    simclr_clustering.py:365-404): the level-decomposed first Linear over
    the per-pixel norm, then the tail with the statistics of all B * H * W
    pixels (one image at a time at serving)."""
    z = project_feature_maps(features, params["lin1"]["weight"], hlen=hlen,
                             interp=interp)
    norms = feature_norm_map(features, hlen)[..., None]
    z = z / torch.clamp(norms, min=1e-12)
    b, h, w, c = z.shape
    return simclr_projection(params, z.reshape(-1, c)).reshape(b, h, w, -1)


class SimCLRClustering:
    """The SimCLR 'preprocessor' of hfc_with_simclr: ``preprocess`` /
    ``pretrain`` / ``predict_simclr_codes`` over a port ``Generator``
    (``model``), saving and loading ``simclr_params.npz`` in ``out_dir`` (the
    JAX package's format).

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. Random numbers (the mean
    latent's z, the params' init, each step's draws) come from one
    ``torch.Generator`` seeded with ``seed``. ``ops`` is ``KERNELS`` or
    ``PLAIN``. With ``record_loss_history`` each step appends its loss to
    ``loss_history`` and its host-clock seconds to ``step_seconds`` (each a
    device sync).
    """

    def __init__(self, model, model_config, perturb_args, simclr_args,
                 logger=None, train=True, out_dir=None, device=None, tb=None,
                 layer_hf_dim=None, seed=42, ops=KERNELS):
        del layer_hf_dim  # in hfc_prep_args; unused, as in the JAX package
        self.device = resolve_device(device)
        self.ops = ops
        self.model_config = model_config
        self.perturb_args = perturb_args
        self.simclr_args = simclr_args
        self.logger = logger
        self.train = train
        self.out_dir = out_dir
        self.writer = tb
        self.record_loss_history = False
        self.loss_history = []
        self.step_seconds = []
        self.pretrain_count = 0
        self.generator = torch.Generator().manual_seed(seed)
        self.nclasses = simclr_args["nclasses"]

        self.params_file = None
        if out_dir is not None:
            os.makedirs(os.path.join(out_dir, "simclr"), exist_ok=True)
            self.params_file = os.path.join(out_dir, "simclr_params.npz")

        self.model = model.to(self.device)
        with torch.no_grad():
            self.mean_latent = _mean_latent(
                self.model, getattr(model_config, "num_latents_for_mean", 4096),
                self.generator, ops)
        self.truncation = model_config.truncation

        self.params = None
        if not self.train and self.params_file and os.path.exists(self.params_file):
            self.params = from_jax_params(load_pytree(self.params_file), self.device)
        elif not self.train and out_dir is not None and os.path.exists(
                os.path.join(out_dir, "projection.pt")):
            not_ported_part("importing the reference's projection.pt "
                            "(simclr_clustering.py:62-67)", "loader")
        elif not self.train and self.logger:
            self.logger.info("Projection File not found - pretraining ...")
        self._image_hw = (model_config.image_size, model_config.image_size)

    def preprocess(self, input_latent):
        if self.train or self.params is None:
            self.pretrain(input_latent)

    def pretrain(self, input_latent=None):
        del input_latent  # a placeholder in the reference too
        sa = self.simclr_args
        self.pretrain_count += 1
        self.params = from_jax_params(
            init_simclr_params(sa["hlen"], sa["nclasses"], self.generator),
            self.device)
        mc = {"truncation": self.truncation,
              "latent_dim": self.model_config.latent_dim}
        optimizer, step = make_simclr_train_step(
            self.model.meta, mc, self.perturb_args, sa, self.mean_latent,
            self._image_hw, self.ops)
        opt_state = optimizer.init(self.params)
        t0 = time.perf_counter()
        for e in range(sa["num_iters"]):
            draws = draw_step_inputs(self.generator, self.model.meta, mc,
                                     self.perturb_args, sa, self._image_hw)
            ts = time.perf_counter()
            self.params, opt_state, loss = step(self.model, self.params,
                                                opt_state, draws)
            if self.record_loss_history:
                self.loss_history.append(float(loss))
                self.step_seconds.append(time.perf_counter() - ts)
            if e % sa.get("epoch_print_freq", 5) == 0:
                if self.logger:
                    self.logger.info(
                        f" (Iter:{e}):\tLoss: {float(loss):.03f},"
                        f"\tTime: {time.perf_counter() - t0:.03f}")
                if self.writer is not None:
                    self.writer.add_scalar("simclr/loss", float(loss), e)
        if self.params_file:
            save_pytree(self.params_file, self.params)

    def predict_simclr_codes(self, input_latent, input_is_latent=True):
        """(NHWC projection scores, their argmax labels) for a latent."""
        z = torch.as_tensor(input_latent, dtype=torch.float32, device=self.device)
        if z.dim() == 1:
            z = z[None]
        with torch.no_grad():
            _, feats = generator_forward(
                self.model, [z], input_is_latent=input_is_latent,
                truncation=self.truncation, truncation_latent=self.mean_latent,
                ops=self.ops)
            scores = simclr_predict_from_features(
                self.params, feats, self.simclr_args["hlen"],
                self.simclr_args.get("hf_interp", "nearest"))
        return scores, scores.argmax(dim=-1)
