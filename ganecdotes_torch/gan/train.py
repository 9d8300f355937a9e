"""BagGAN-HQ training engine and base-model scaffolding (port of
ganecdotes_tpu/gan/train.py).

One iteration (``optimize_parameters``, as the JAX package's :770-809):
the D step with the WGAN-GP mixed penalty (or the plain adversarial loss of
the other modes), lazy R1 every ``d_reg_every`` iterations, the G step, and
lazy path-length regularization every ``g_reg_every`` iterations; ADA
augments D's inputs in the D, R1 and G steps, and its controller tunes p
after each D step when ``augment_p`` is 0. Reg-ratio-scaled Adam pairs,
linear/step/cosine/plateau LR policies, per-net ``.npz`` checkpoints in
the JAX package's format ('%s_net_%s.npz', loadable by either package).

Random numbers are drawn up front, never inside a step: ``set_input``
fills a ``BagGANDraws`` record from the trainer's ``torch.Generator``
(``draw_step_inputs``), or takes one passed in, so a test can hand the port
the draws the JAX step makes from its keys. The trainer's own ADA draws
are raw (``ada.TransformDraws``) and are composed into matrices at the
start of the iteration that uses them, at ADA's p of that moment as a
device tensor, so drawing needs no host sync.

Every op runs through an op set: ``KERNELS`` (the CUDA kernels as autograd
Functions) or ``PLAIN``. The PPL step takes gradients of gradients through
the synthesis network, and the StyledConv kernels are first-order only, so
its op set swaps those two for composites (the JAX trainer refuses the
Pallas StyledConvs under PPL, train.py:219-235): ``styled_conv3x3_ref``,
and ``styled_up_conv3x3_xla`` with its blur on the set's ``upfirdn2d`` (the
FIR kernel with ``KERNELS``, so ``PLAIN`` stays all plain); every other op
on that path keeps its kernel.

Under ``gan_mode='wgangp'`` the D step recomputes as the JAX trainer does
(``wgangp_remat``, :360-368, :431-470): the gradient-penalty branch always
runs under ``torch.utils.checkpoint``, and ``'all'`` (the default) also
checkpoints the step's two D forwards, so their activations are recomputed
in the backward instead of kept; ``'gp'`` keeps them.

``data_parallel`` in a process group of more than one rank (``torchrun``,
``parallel.mesh.distributed_init``) trains over the ranks, as the JAX
trainer shards its steps over the mesh: every rank draws the global
batch's ``BagGANDraws`` and takes the global batch's images, then keeps its
slice; each step's gradients are averaged over the ranks, the minibatch
standard deviation, ADA's sign statistics and the PPL's mean path length
are the global batch's, and the reported losses are the global means, so
N ranks reproduce one process on the global batch. Only rank 0 writes
checkpoints.

``compute_dtype='bfloat16'`` runs the D and G adversarial steps in bf16,
as the JAX trainer does (train.py:369-470, :492-495, :516-526): the
synthesis (its mapping in float32) and D on bf16 activations, the real
batch cast to bf16 before ADA, D's predictions cast to float32 before the
losses and the ADA controller, the WGAN-GP penalty's interpolates cast
back to float32 (its D runs in float32), R1 and PPL in float32, parameters
and Adam moments float32 (each weight meets the activation in its type:
the casts' backward brings the gradient back to float32), and the D
step's image returned in float32. On the card the kernels' bf16 instances
run. ``'float32'`` (or None) is the default path itself; any other type
raises ``NotImplementedError``.

``optimize_parameters_chunk`` (the JAX trainer's fused multi-iteration
call, train.py:583-637, :811-880) runs a list of batches: each iteration
whose lazy regularisation is due goes through ``set_input`` +
``optimize_parameters``; each run of plain (D, G) iterations is staged
(its batches on the device and its draws taken from the generator in the
single-step order) and then executed back to back with no host sync, the
losses kept as device tensors until the run ends. A chunked run follows
the single-stepped trajectory.
"""

import functools
import math
import os
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ganecdotes_torch import compute_dtype, resolve_device
from ganecdotes_torch.gan.ada import (
    TransformDraws,
    ada_init_state,
    ada_update,
    augment,
    compose_transforms,
    draw_transforms,
    sample_transforms,
)
from ganecdotes_torch.gan.losses import (
    gan_loss,
    gradient_penalty,
    path_length_penalty,
    r1_penalty,
)
from ganecdotes_torch.models.baggan.convert import BAGGAN_RES_TO_CHANNEL_MAP
from ganecdotes_torch.models.stylegan2.convert import _flatten, module_tree, tree_to_state
from ganecdotes_torch.models.stylegan2.discriminator import (
    Discriminator,
    discriminator_forward,
)
from ganecdotes_torch.models.stylegan2.generator import (
    Generator,
    generator_forward,
    make_noise,
    mapping_apply,
)
from ganecdotes_torch.ops.modulated_conv import styled_conv3x3_ref, styled_up_conv3x3_xla
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.parallel.mesh import (
    average_gradients,
    make_mesh,
    mean_over_ranks,
    replicate,
    shard_batch,
)
from ganecdotes_torch.pipeline.schedulers import plateau_lr
from ganecdotes_torch.utils import tracing
from ganecdotes_torch.utils.optim import Adam
from ganecdotes_torch.utils.serialization import load_pytree, save_pytree
from ganecdotes_torch.utils.util import get_logger

STEP_KINDS = ("d", "r1", "g", "ppl")
# the steps' spans (utils/tracing.py), inside an iteration's "gan.optimize";
# in a step, ADA's augment is "gan.ada" and the gradient "gan.grad"
STEP_SPANS = {"d": "gan.d_step", "r1": "gan.r1", "g": "gan.g_step", "ppl": "gan.ppl"}


def initialize_params(params, generator, init_type="normal", init_gain=0.02):
    """Re-initialise every conv / linear weight of a params tree (nested
    dicts and lists of tensors; HWIO and (in, out) layouts): zeros for 1-D
    leaves (biases), else normal, xavier, kaiming or orthogonal draws from
    the ``torch.Generator`` (the reference's ``initialize_net``,
    gan_util.py:129-166). Leaves are drawn in sorted-key order, as the
    JAX package flattens its tree. Returns a new tree."""

    def init_leaf(leaf):
        if leaf.dim() == 1:
            return torch.zeros_like(leaf)
        fan_in, fan_out = math.prod(leaf.shape[:-1]), leaf.shape[-1]

        def normal(shape):
            return torch.randn(shape, generator=generator).to(leaf)

        if init_type == "normal":
            return init_gain * normal(leaf.shape)
        if init_type == "xavier":
            return init_gain * math.sqrt(2.0 / (fan_in + fan_out)) * normal(leaf.shape)
        if init_type == "kaiming":
            return math.sqrt(2.0 / fan_in) * normal(leaf.shape)
        if init_type == "orthogonal":
            flat = torch.randn(fan_in, fan_out, generator=generator)
            q, r = torch.linalg.qr(flat if fan_in >= fan_out else flat.T)
            q = q * torch.sign(torch.diagonal(r))[None, :]
            if fan_in < fan_out:
                q = q.T
            return (init_gain * q.reshape(leaf.shape)).to(leaf)
        raise NotImplementedError(f"init type {init_type} not found")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return init_leaf(node)

    return walk(params)


def get_scheduler(lr_policy, epoch_count=None, n_epochs=None,
                  n_epochs_decay=None, lr_decay_iters=None):
    """LR multiplier schedule f(epoch) (ref gan_util.py:72-127)."""
    if lr_policy == "linear":
        def sched(epoch):
            return 1.0 - max(0, epoch + (epoch_count or 1) - (n_epochs or 100)) / float(
                (n_epochs_decay or 100) + 1)
    elif lr_policy == "step":
        def sched(epoch):
            return 0.1 ** (epoch // (lr_decay_iters or 50))
    elif lr_policy == "cosine":
        def sched(epoch):
            return 0.5 * (1 + math.cos(math.pi * epoch / (n_epochs or 100)))
    elif lr_policy == "plateau":
        # ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
        # patience=5), the reference's arguments (gan_util.py:110-115)
        return plateau_lr(patience=5, factor=0.2, threshold=0.01)
    else:
        raise NotImplementedError(f"lr policy {lr_policy} not found")
    return sched


class GANBaseModel:
    """Checkpoint / scheduler / logging scaffolding (ref base_model.py:8-307).
    ``model_names`` maps an attribute holding an ``nn.Module`` to its file
    name ('G', 'D')."""

    def __init__(self, config):
        self.config = config
        self.is_train = getattr(config, "is_train", True)
        self.out_dir = getattr(config, "out_dir", ".")
        self.checkpoint_dir = getattr(config, "checkpoint_dir", self.out_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.logger = get_logger(getattr(config, "baggan_logger_name", "BagGAN"),
                                 getattr(config, "training_log_path", None))
        self.model_names = {}
        self.loss_names = []
        self.epoch = getattr(config, "start_epoch", 1)
        self._lr_mult = 1.0

    def setup_gan(self):
        """Schedulers + continue-train resume (ref base_model.py:69-101)."""
        if self.is_train:
            self.scheduler = get_scheduler(getattr(self.config, "lr_policy", "linear"),
                                           **getattr(self.config, "lr_params", {}))
        if getattr(self.config, "continue_train", False) or getattr(
                self.config, "load_net", False):
            suffix = getattr(self.config, "load_epoch", None)
            if suffix is not None:
                self.load_networks(suffix)

    def update_learning_rate(self, metric=None):
        """Per-epoch LR policy step (ref base_model.py:118-134)."""
        self.epoch += 1
        if hasattr(self.scheduler, "step"):
            self._lr_mult = self.scheduler.step(0.0 if metric is None else metric)
        else:
            self._lr_mult = self.scheduler(self.epoch)
        self.logger.info(f"learning rate mult = {self._lr_mult:.7f}")
        return self._lr_mult

    def get_current_losses(self):
        return {name: float(getattr(self, "loss_" + name))
                for name in self.loss_names if hasattr(self, "loss_" + name)}

    def _net_path(self, suffix, name):
        return os.path.join(self.checkpoint_dir, f"{suffix}_net_{name}.npz")

    def save_networks(self, suffix):
        """Each net's params and buffers as the JAX package's pytree file
        (under data parallel, rank 0's)."""
        mesh = getattr(self, "mesh", None)
        if mesh is not None and mesh.rank != 0:
            return
        for attr, name in self.model_names.items():
            save_pytree(self._net_path(suffix, name), module_tree(getattr(self, attr)))
            self.logger.info(f"saved {self._net_path(suffix, name)}")

    def load_networks(self, suffix):
        for attr, name in self.model_names.items():
            path = self._net_path(suffix, name)
            if not os.path.exists(path):
                self.logger.warning(f"checkpoint missing: {path}")
                continue
            net = getattr(self, attr)
            state = tree_to_state(load_pytree(path))
            with torch.no_grad():
                for key, t in net.state_dict(keep_vars=True).items():
                    t.copy_(state[key])
            self.logger.info(f"loaded {path}")

    def print_networks(self, verbose=False):
        for attr, name in self.model_names.items():
            net = getattr(self, attr)
            n = sum(p.numel() for p in net.parameters())
            self.logger.info(f"[Network {name}] Total parameters: {n / 1e6:.3f} M")
            if verbose:
                self.logger.info(str(net))

    def set_requires_grad(self, nets, requires_grad=False):
        """A no-op, kept for parity with the JAX package's API (ref
        base_model.py:289-307). Each step takes the gradients of the tensors
        it names (``BagGANHQ._apply``: ``torch.autograd.grad(loss,
        tensors)``), so a flag changes nothing a step computes, and D's
        weights with the flag off would make the D step raise."""

    def eval(self):
        """A no-op, kept for parity with the JAX package's API: the nets
        have no dropout and no batch statistics, so there is no train or
        eval mode to set."""


class BagGANDraws(NamedTuple):
    """The random numbers of one BagGAN iteration, on the trainer's device.
    An augmentation is its ``(G, C)`` matrices, or its raw
    ``ada.TransformDraws`` to compose at the iteration's p (None without
    ADA)."""

    z: List[torch.Tensor]  # 1 or 2 (B, latent) normals (2: style mixing)
    inject_index: int  # w+ rows below it take z[0]'s w; n_latent if unmixed
    d_noise: List[torch.Tensor]  # per-layer noise of the D step's synthesis
    d_fake_aug: Optional[Tuple[torch.Tensor, torch.Tensor]]
    d_real_aug: Optional[Tuple[torch.Tensor, torch.Tensor]]
    gp_alpha: torch.Tensor  # (B, 1, 1, 1) WGAN-GP interpolation
    r1_aug: Optional[Tuple[torch.Tensor, torch.Tensor]]  # None: no R1 due
    g_noise: List[torch.Tensor]  # per-layer noise of the G step's synthesis
    g_aug: Optional[Tuple[torch.Tensor, torch.Tensor]]
    ppl_z: Optional[torch.Tensor]  # (B // path_batch_shrink, latent); None: no PPL due
    ppl_noise_imgs: Optional[torch.Tensor]  # (pb, H, W, C) N(0, 1) / H


def draw_step_inputs(generator, config, gen_meta, batch, iter_no, ada_p,
                     device=None):
    """One iteration's ``BagGANDraws`` from ``generator`` (on the CPU, moved
    to ``device``): the latents, the mixing coin and inject index, the
    noise maps, the ADA matrices at probability ``ada_p`` (a float; None
    keeps them raw, ``ada.TransformDraws``, for ``compose_draws``), the GP
    alpha, and the R1 and PPL draws when those are due at ``iter_no``. The
    generator's stream is the same either way."""
    g = generator
    n_latent = gen_meta["n_latent"]
    size, lat_dim = gen_meta["size"], gen_meta["style_dim"]
    z = torch.randn(2, batch, lat_dim, generator=g).to(device)
    mix = getattr(config, "mixing_prob", 0.0)
    if mix > 0 and float(torch.rand((), generator=g)) < mix:
        # the reference's random.randint(1, n_latent - 1), both ends included
        zs = [z[0], z[1]]
        inject = int(torch.randint(1, n_latent, (), generator=g))
    else:
        zs, inject = [z[0]], n_latent
    use_aug = getattr(config, "augment", False)

    def aug():
        if not use_aug:
            return None
        if ada_p is None:
            return draw_transforms(g, batch, size, size)
        return sample_transforms(g, ada_p, batch, size, size, device)

    d_noise = make_noise(gen_meta, batch, g, device)
    d_fake_aug, d_real_aug = aug(), aug()
    gp_alpha = torch.rand(batch, 1, 1, 1, generator=g).to(device)
    r1_aug = aug() if iter_no % config.d_reg_every == 0 else None
    g_noise = make_noise(gen_meta, batch, g, device)
    g_aug = aug()
    ppl_z = ppl_noise = None
    if getattr(config, "use_ppl", False) and iter_no % config.g_reg_every == 0:
        pb = max(1, batch // getattr(config, "path_batch_shrink", 2))
        ppl_z = torch.randn(pb, lat_dim, generator=g).to(device)
        ppl_noise = (torch.randn(pb, size, size, getattr(config, "num_channels", 3),
                                 generator=g) / float(size)).to(device)
    return BagGANDraws(zs, inject, d_noise, d_fake_aug, d_real_aug, gp_alpha,
                       r1_aug, g_noise, g_aug, ppl_z, ppl_noise)


def compose_draws(draws, p):
    """``draws`` with every raw ``ada.TransformDraws`` composed into (G, C)
    at probability ``p`` (a 0-d device tensor: no host sync)."""
    def one(t):
        return compose_transforms(t, p) if isinstance(t, TransformDraws) else t

    return draws._replace(d_fake_aug=one(draws.d_fake_aug),
                          d_real_aug=one(draws.d_real_aug),
                          r1_aug=one(draws.r1_aug), g_aug=one(draws.g_aug))


def _shard(mesh, t):
    """The rank's slice of every tensor in ``t`` (tensors, lists, tuples,
    named tuples; batch-leading)."""
    if isinstance(t, torch.Tensor):
        return shard_batch(mesh, t)
    if isinstance(t, TransformDraws):
        return TransformDraws(*(_shard(mesh, u) for u in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_shard(mesh, u) for u in t)
    return t


class BagGANHQ(GANBaseModel):
    """StyleGAN2 GAN trainer for baggage imagery (ref bagganhq.py:14-501).

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. ``ops`` is ``KERNELS``
    or ``PLAIN``. Weights are drawn from a ``torch.Generator`` seeded with
    ``seed``, which also draws every iteration's ``BagGANDraws``. The
    config's ``compute_dtype`` ('float32', None or 'bfloat16') is
    ``compute_dtype`` here: None or ``torch.bfloat16``.

    Spans (``utils/tracing.py``, recorded while a profiler or
    ``tracing.start()`` records): ``gan.optimize`` a root of each iteration
    (its id the iteration), ``STEP_SPANS`` of its steps, ``gan.ada`` and
    ``gan.grad`` in them, and ``gan.draw`` a root of each iteration's draws
    (the same id); a step's launches and device time are its span's.
    ``keep_first_grads = True`` keeps each step kind's first gradients in
    ``first_grads``.
    """

    def __init__(self, config, seed=0, device=None, ops=KERNELS):
        super().__init__(config)
        # float32 is the default path itself: no casts
        self.compute_dtype = compute_dtype(getattr(config, "compute_dtype", None))
        self.wgangp_remat = getattr(config, "wgangp_remat", "all")
        if self.wgangp_remat not in ("all", "gp"):
            raise NotImplementedError(
                f"wgangp_remat={self.wgangp_remat!r}: expected 'all' or 'gp'")
        self.device = resolve_device(device)
        self.mesh = None
        if (getattr(config, "data_parallel", False) and dist.is_initialized()
                and dist.get_world_size() > 1):
            self.mesh = make_mesh(device=self.device)
        self.ops = ops
        self.ppl_ops = ops._replace(
            styled_conv3x3=styled_conv3x3_ref,
            styled_up_conv3x3=functools.partial(styled_up_conv3x3_xla,
                                                fir=ops.upfirdn2d))
        self.loss_names = getattr(config, "losses_to_print", ["g_gan", "d"])
        self.model_names = {"netG": "G", "netD": "D"} if self.is_train else {"netG": "G"}
        self.generator = torch.Generator().manual_seed(seed)

        size = config.image_size
        cm = getattr(config, "chl_multiplier", 2)
        r2c = getattr(config, "res2chlmap", None)
        if r2c == "baggan":
            r2c = BAGGAN_RES_TO_CHANNEL_MAP
        self.netG = Generator(size, style_dim=config.latent_dim,
                              n_mlp=config.generator_params.get("mlp_layers", 8),
                              channel_multiplier=cm, res2chlmap=r2c,
                              generator=self.generator).to(self.device)
        self.gen_meta = self.netG.meta
        self.latent_size = config.latent_dim
        self.mean_path_length = torch.zeros((), device=self.device)
        self.ada_state = ada_init_state(getattr(config, "augment_p", 0) or 0.0,
                                        self.device)
        self.iter_no = 0
        self.draws = None
        self.keep_first_grads = False
        self.first_grads = {}
        self.logger.info("Initialized Generator " + "+" * 40)

        if self.is_train:
            self.netD = Discriminator(size, channel_multiplier=cm,
                                      in_channels=getattr(config, "num_channels", 3),
                                      generator=self.generator).to(self.device)
            self.logger.info("Initialized Discriminator " + "+" * 40)
            self.adversarial_loss = gan_loss(config.gan_mode)
            # the JAX trainer's G tree holds the fixed noise maps, so its
            # Adam moves them too (the PPL step reads them); so does this one
            for buf in self.netG.noises:
                buf.requires_grad_(True)
            self.g_tensors = list(self.netG.parameters()) + list(self.netG.noises)
            self.d_tensors = list(self.netD.parameters())
            g_rr, d_rr = config.g_reg_ratio, config.d_reg_ratio
            self._base_lrs = (config.lr * g_rr, config.lr * d_rr)
            self.optimizer_g = Adam(self.g_tensors, config.lr * g_rr,
                                    b1=config.beta1, b2=0.99**g_rr)
            self.optimizer_d = Adam(self.d_tensors, config.lr * d_rr,
                                    b1=config.beta1, b2=0.99**d_rr)
            self.optimizers = [self.optimizer_g, self.optimizer_d]
            self.use_aug = getattr(config, "augment", False)
            # 'auto' is the kernel path: the op set picks kernel or plain
            warp = getattr(config, "ada_warp_impl", "auto")
            self._ada_warp_impl = "shear_pallas" if warp == "auto" else warp
            self.tune_ada = self.use_aug and (getattr(config, "augment_p", 0) or 0) == 0
        if self.mesh is not None:  # every rank starts from rank 0's weights
            with torch.no_grad():
                for net in (self.netG, getattr(self, "netD", None)):
                    for t in [] if net is None else net.state_dict().values():
                        t.copy_(replicate(self.mesh, t))

    def training_state(self):
        """The state a run resumes from, as a tree for
        ``utils.serialization``: both nets' parameters and buffers
        (``module_tree``'s nesting), each Adam's moments, update count and
        learning rate, ADA's state, the mean path length, the iteration and
        the draws' generator state (the learning-rate schedule's is not in
        it). The nets', moments', ADA's and path length's tensors are the
        trainer's own, so ``load_pytree_orbax(path,
        like=gan.training_state())`` restores them in place on the
        trainer's device; the counts, rates, iteration and generator state
        are copies: hand the restored tree to ``load_training_state``."""
        tree = {"netG": module_tree(self.netG, own=True), "ada": self.ada_state,
                "mean_path_length": self.mean_path_length,
                "iter_no": torch.tensor(self.iter_no), "rng": self.generator.get_state()}
        if self.is_train:
            tree["netD"] = module_tree(self.netD, own=True)
            for name, opt in (("adam_g", self.optimizer_g), ("adam_d", self.optimizer_d)):
                tree[name] = {"m": opt.m, "v": opt.v, "count": torch.tensor(opt.count),
                              "lr": torch.tensor(opt.lr, dtype=torch.float64)}
        return tree

    def load_training_state(self, tree):
        """Take back a ``training_state`` tree (as ``load_pytree_orbax``
        returns it, with or without ``like``, or ``load_pytree``): each
        tensor is copied into the trainer's own (nothing to copy where it
        was restored in place), and the counts, rates, iteration and
        generator state are set. A key either side lacks, or a tensor of
        another shape or dtype, raises."""
        own, got = dict(_flatten(self.training_state())), dict(_flatten(tree))
        if own.keys() != got.keys():
            raise KeyError(f"training state: {sorted(own.keys() ^ got.keys())} "
                           "on one side only")
        for key, t in own.items():
            new = got[key]
            if new.shape != t.shape or new.dtype != t.dtype:
                raise ValueError(f"training state {key}: {tuple(new.shape)} {new.dtype}, "
                                 f"the trainer's {tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            for key, t in own.items():
                if got[key] is not t:
                    t.copy_(got[key])
        self.iter_no = int(got["iter_no"])
        self.generator.set_state(got["rng"].cpu())
        for name, opt in (("adam_g", getattr(self, "optimizer_g", None)),
                          ("adam_d", getattr(self, "optimizer_d", None))):
            if opt is not None:
                opt.count, opt.lr = int(got[f"{name}.count"]), float(got[f"{name}.lr"])

    @property
    def ada_aug_p(self):
        return float(self.ada_state["p"])

    @property
    def r_t_stat(self):
        return float(self.ada_state["r_t"])

    # ------------------------------------------------------------------

    @contextmanager
    def _step(self, kind):
        """One step's span.

        The step's backward passes run on this thread, not on the device's
        autograd thread. The engine runs ready graph nodes in the order of
        their sequence numbers, which each thread counts apart; the gradient
        graph that a double backward (the D step's gradient penalty, R1,
        PPL) builds on the device's thread is numbered from that thread's
        count, so the engine interleaved it with the forward graph in
        another order on the first run in a process than on later ones, and
        summed some gradients in another order: a training run's bits
        depended on what the process had run before."""
        with tracing.span(STEP_SPANS[kind]), \
                torch.autograd.set_multithreading_enabled(False):
            yield

    def _apply(self, kind, optimizer, loss, tensors):
        with tracing.span("gan.grad"):
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = average_gradients(self.mesh, [torch.zeros_like(t) if g is None else g
                                              for t, g in zip(tensors, grads)])
        if self.keep_first_grads and kind not in self.first_grads:
            self.first_grads[kind] = [g.detach().clone() for g in grads]
        optimizer.step(grads)

    def _augment(self, img, transform):
        if not self.use_aug:
            return img
        if isinstance(transform, TransformDraws):  # a step called on its own
            transform = compose_transforms(transform, self.ada_state["p"])
        with tracing.span("gan.ada"):
            return augment(img, transform_matrix=transform,
                           warp_impl=self._ada_warp_impl, ops=self.ops)[0]

    def _disc(self, x):
        return discriminator_forward(self.netD, x, self.ops, self.mesh)

    def _disc_remat(self, x):
        """``_disc`` under activation checkpointing: its activations are
        recomputed in the backward, also when that backward builds a graph
        (the gradient penalty's). D draws no random numbers, so the RNG
        state is not stashed."""
        return checkpoint(self._disc, x, use_reentrant=False,
                          preserve_rng_state=False)

    def _synth(self, z, noise, inject_index):
        """Style-mixed synthesis from z (mapping each z, in float32) with
        the noise maps passed in, in ``compute_dtype``."""
        ws = [mapping_apply(self.netG, zz, self.ops) for zz in z]
        img, _ = generator_forward(self.netG, ws, input_is_latent=True,
                                   noise=noise, inject_index=inject_index,
                                   return_latents=True, ops=self.ops,
                                   dtype=self.compute_dtype)
        return img

    def _pred32(self, pred):
        """D's predictions in float32 for the losses and ADA's statistics."""
        return pred if self.compute_dtype is None else pred.float()

    def d_step(self, real, draws):
        """D step: WGAN-GP mixed penalty under 'wgangp' (the 0.25/0.25/0.5
        combination of the JAX trainer; the penalty branch checkpointed, and
        the two D forwards too under ``wgangp_remat='all'``), the ADA
        controller after it."""
        cd = self.compute_dtype
        with self._step("d"):
            with torch.no_grad():
                fake = self._synth(draws.z, draws.d_noise, draws.inject_index)
                d_fake = self._augment(fake, draws.d_fake_aug)
                d_real = self._augment(real if cd is None else real.to(cd),
                                       draws.d_real_aug)
            wgangp = self.config.gan_mode == "wgangp"
            fwd = self._disc_remat if wgangp and self.wgangp_remat == "all" else self._disc
            pred_fake = self._pred32(fwd(d_fake))
            pred_real = self._pred32(fwd(d_real))
            loss_out = self.adversarial_loss(pred_fake, False)
            loss_ref = self.adversarial_loss(pred_real, True)
            if wgangp:
                # the penalty's D runs in float32 whatever compute_dtype
                gp, _ = gradient_penalty(self._disc_remat, d_real.float(),
                                         d_fake.float(), draws.gp_alpha)
                loss = (loss_out + loss_ref) * 0.25 + gp * 0.5
            else:
                loss = loss_out + loss_ref
            self._apply("d", self.optimizer_d, loss, self.d_tensors)
            if self.tune_ada:
                self.ada_state = ada_update(self.ada_state, pred_real,
                                            self.config.ada_target,
                                            self.config.ada_length, 8, self.mesh)
        return (*(mean_over_ranks(self.mesh, t.detach())
                  for t in (loss, loss_out, loss_ref)), fake.float())

    def r1_step(self, real, draws):
        cfg = self.config
        with self._step("r1"):
            penalty, pred = r1_penalty(
                lambda x: self._disc(self._augment(x, draws.r1_aug)), real)
            loss = cfg.r1_lambda / 2 * penalty * cfg.d_reg_every + 0 * pred[0, 0]
            self._apply("r1", self.optimizer_d, loss, self.d_tensors)
        return mean_over_ranks(self.mesh, loss.detach())

    def g_step(self, draws):
        with self._step("g"):
            fake = self._synth(draws.z, draws.g_noise, draws.inject_index)
            pred_fake = self._pred32(self._disc(self._augment(fake, draws.g_aug)))
            loss = self.adversarial_loss(pred_fake, True)
            self._apply("g", self.optimizer_g, loss, self.g_tensors)
        return mean_over_ranks(self.mesh, loss.detach())

    def ppl_step(self, draws):
        """Path-length regularization through the synthesis from the mapping
        of fresh z, with the fixed noise maps; returns (raw ppl, new mean)."""
        cfg = self.config
        n_latent = self.gen_meta["n_latent"]
        with self._step("ppl"):
            w = mapping_apply(self.netG, draws.ppl_z, self.ppl_ops)
            lat = w[:, None, :].expand(-1, n_latent, -1)

            def gen_from_lat(lat_):
                return generator_forward(self.netG, [lat_], input_is_latent=True,
                                         return_latents=True, ops=self.ppl_ops)[0]

            ppl, new_mean, _ = path_length_penalty(
                gen_from_lat, lat, draws.ppl_noise_imgs, self.mean_path_length,
                decay=cfg.ppl_decay, mesh=self.mesh)
            self._apply("ppl", self.optimizer_g, cfg.ppl_lambda * cfg.g_reg_every * ppl,
                        self.g_tensors)
        return mean_over_ranks(self.mesh, ppl.detach()), new_mean

    # ------------------------------------------------------------------

    def set_input(self, data_sample=None, iter_no=None, epoch_no=None,
                  latent=None, gen_args=None, draws=None):
        """Stage a training batch (ref bagganhq.py:155-205) and the
        iteration's draws: ``draws`` if given, else drawn from the trainer's
        generator (the ADA matrices raw, composed when the iteration runs).
        Under data parallel the batch, the draws and ``latent`` are the
        global batch's, and the rank keeps its slice of each."""
        self.iter_no = iter_no if iter_no is not None else self.iter_no
        self.epoch_no = epoch_no
        self.ref_image, self.draws = self._stage(data_sample, self.iter_no,
                                                 latent, draws)
        self.bsize = self.ref_image.shape[0] * (1 if self.mesh is None else self.mesh.size)
        self.input_latent = self.draws.z
        self.inject_index = (self.draws.inject_index if len(self.draws.z) > 1
                             else None)
        self.gen_args = gen_args

    def _stage(self, data_sample, iter_no, latent=None, draws=None):
        """(the rank's batch on the device, the iteration's draws) for
        iteration ``iter_no``, the generator's draws taken in the order the
        single-step path takes them."""
        cfg = self.config
        if data_sample is not None:
            img = data_sample["ct"] if isinstance(data_sample, dict) else data_sample
            real = torch.as_tensor(img, dtype=torch.float32).to(self.device).contiguous()
        else:
            real = torch.zeros(cfg.batch_size, cfg.image_size, cfg.image_size,
                               getattr(cfg, "num_channels", 3), device=self.device)
        if draws is None:
            with tracing.span("gan.draw", id=iter_no):
                draws = draw_step_inputs(self.generator, cfg, self.gen_meta,
                                         real.shape[0], iter_no, None, self.device)
        if latent is not None:
            latent = latent if isinstance(latent, (list, tuple)) else [latent]
            draws = draws._replace(z=list(latent), inject_index=self.gen_meta["n_latent"])
        if self.mesh is not None:
            real = shard_batch(self.mesh, real)
            draws = draws._replace(**{f: _shard(self.mesh, getattr(draws, f))
                                      for f in draws._fields})
        return real, draws

    def forward(self):
        """(image, latent, features) sample with fresh noise (ref :207-223)."""
        noise = make_noise(self.gen_meta, self.input_latent[0].shape[0],
                           self.generator, self.device)
        with torch.no_grad():
            img, lat, feats = generator_forward(
                self.netG, self.input_latent, noise=noise,
                inject_index=self.inject_index, return_latents="all", ops=self.ops,
                **(self.gen_args or {}))
        self.out_image, self.out_latent, self.features = img, lat, feats
        return self.out_image

    def optimize_parameters(self):
        """One full GAN iteration: D, lazy R1, ADA tune, G, lazy PPL
        (ref bagganhq.py:432-483)."""
        cfg = self.config
        with tracing.span("gan.optimize", id=self.iter_no):
            # the iteration's ADA matrices at p before its D step updates it
            d = self.draws = compose_draws(self.draws, self.ada_state["p"])
            self.loss_d, self.loss_d_out, self.loss_d_ref, _ = self.d_step(
                self.ref_image, d)
            if self.iter_no % cfg.d_reg_every == 0:
                self.loss_d_r1 = self.r1_step(self.ref_image, d)
            self.loss_g_gan = self.g_step(d)
            self.loss_g = self.loss_g_gan
            if getattr(cfg, "use_ppl", False) and self.iter_no % cfg.g_reg_every == 0:
                self.loss_g_ppl, self.mean_path_length = self.ppl_step(d)
        self.iter_no += 1

    def optimize_parameters_chunk(self, real_batches):
        """``len(real_batches)`` full GAN iterations from the current
        ``iter_no`` (port of the JAX trainer's fused chunk,
        train.py:811-880). An iteration whose R1 (every ``d_reg_every``) or
        PPL (every ``g_reg_every``, with ``use_ppl``) is due runs through
        ``set_input`` + ``optimize_parameters``, the single-step code; each
        run of plain (D, G) iterations between them is staged, then run by
        ``_run_dg_chunk`` back to back with no host sync. The draws are
        taken from the generator in the single-step order, so the run
        follows the single-stepped trajectory. ``real_batches``: (B, H, W,
        C) arrays or ``{'ct': array}`` samples, as ``set_input`` takes.

        The plain iterations leave ``ref_image``, ``draws`` and
        ``input_latent`` as the last ``set_input`` left them; call
        ``set_input`` before ``forward()`` / ``test()`` after a chunk."""
        cfg = self.config
        use_ppl = getattr(cfg, "use_ppl", False)
        run = []
        for b in real_batches:
            it = self.iter_no + len(run)
            if it % cfg.d_reg_every == 0 or (use_ppl and it % cfg.g_reg_every == 0):
                self._run_dg_chunk(run)
                run = []
                self.set_input(data_sample=b, iter_no=self.iter_no)
                self.optimize_parameters()
                continue
            run.append(self._stage(b, it))
        self._run_dg_chunk(run)

    def _run_dg_chunk(self, run):
        """A staged run of plain iterations, [(batch, draws)], each its D
        step at the iteration's p (its ADA matrices composed there), then
        its G step. Nothing here reads a device value: the losses stay
        device tensors (the last iteration's are the attributes)."""
        for real, draws in run:
            with tracing.span("gan.optimize", id=self.iter_no):
                d = compose_draws(draws, self.ada_state["p"])
                self.loss_d, self.loss_d_out, self.loss_d_ref, _ = self.d_step(real, d)
                self.loss_g_gan = self.loss_g = self.g_step(d)
            self.iter_no += 1

    def update_learning_rate(self, metric=None):
        mult = super().update_learning_rate(metric)
        self.optimizer_g.lr = self._base_lrs[0] * mult
        self.optimizer_d.lr = self._base_lrs[1] * mult
        return mult

    def test(self):
        """No-grad forward for sampling (ref :486-501)."""
        return self.forward()
