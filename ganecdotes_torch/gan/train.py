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
the draws the JAX step makes from its keys.

Every op runs through an op set: ``KERNELS`` (the CUDA kernels as autograd
Functions) or ``PLAIN``. The PPL step takes gradients of gradients through
the synthesis network, and the StyledConv kernels are first-order only, so
its op set swaps those two for composites (the JAX trainer refuses the
Pallas StyledConvs under PPL, train.py:219-235): ``styled_conv3x3_ref``,
and ``styled_up_conv3x3_xla`` with its blur on the set's ``upfirdn2d`` (the
FIR kernel with ``KERNELS``, so ``PLAIN`` stays all plain); every other op
on that path keeps its kernel.

Not ported (each raises ``NotImplementedError``): the fused multi-iteration
``optimize_parameters_chunk``, ``compute_dtype='bfloat16'`` and
``data_parallel`` over more than one card. ``wgangp_remat`` is validated
but recomputes nothing: the port keeps every D residual.
"""

import functools
import math
import os
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from ganecdotes_torch import resolve_device
from ganecdotes_torch.gan.ada import ada_init_state, ada_update, augment, sample_transforms
from ganecdotes_torch.gan.losses import (
    gan_loss,
    gradient_penalty,
    path_length_penalty,
    r1_penalty,
)
from ganecdotes_torch.models.baggan.convert import BAGGAN_RES_TO_CHANNEL_MAP
from ganecdotes_torch.models.stylegan2.convert import module_tree, tree_to_state
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
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.modulated_conv import styled_conv3x3_ref, styled_up_conv3x3_xla
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.pipeline.schedulers import plateau_lr
from ganecdotes_torch.utils.optim import Adam
from ganecdotes_torch.utils.serialization import load_pytree, save_pytree
from ganecdotes_torch.utils.util import get_logger

STEP_KINDS = ("d", "r1", "g", "ppl")
# torch.profiler ranges of the steps; ADA's augment runs inside "gan.ada"
PROFILE_RANGES = {"d": "gan.d_step", "r1": "gan.r1", "g": "gan.g_step",
                  "ppl": "gan.ppl"}


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
        """Each net's params and buffers as the JAX package's pytree file."""
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


class BagGANDraws(NamedTuple):
    """The random numbers of one BagGAN iteration, on the trainer's device.
    An augmentation is its ``(G, C)`` matrices (None without ADA)."""

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
    noise maps, the ADA matrices at probability ``ada_p`` (a float), the GP
    alpha, and the R1 and PPL draws when those are due at ``iter_no``."""
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


class BagGANHQ(GANBaseModel):
    """StyleGAN2 GAN trainer for baggage imagery (ref bagganhq.py:14-501).

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. ``ops`` is ``KERNELS``
    or ``PLAIN``. Weights are drawn from a ``torch.Generator`` seeded with
    ``seed``, which also draws every iteration's ``BagGANDraws``.

    Instrumentation, for measuring runs: ``step_launches`` sums each
    kernel's launches per step kind ('d', 'r1', 'g', 'ppl'), always;
    ``time_steps = True`` records host-clock ms per step in ``step_ms``
    (synchronising the device around each step); ``keep_first_grads = True``
    keeps each step kind's first gradients in ``first_grads``.
    """

    def __init__(self, config, seed=0, device=None, ops=KERNELS):
        super().__init__(config)
        if getattr(config, "compute_dtype", None) not in (None, "float32", torch.float32):
            if getattr(config, "compute_dtype", None) in ("bfloat16", torch.bfloat16):
                raise NotImplementedError("compute_dtype='bfloat16' is not ported yet")
            raise NotImplementedError(
                f"compute_dtype={config.compute_dtype!r}: expected None, "
                "'float32' or 'bfloat16'")
        wgangp_remat = getattr(config, "wgangp_remat", "all")
        if wgangp_remat not in ("all", "gp"):
            raise NotImplementedError(f"wgangp_remat={wgangp_remat!r}: expected 'all' or 'gp'")
        self.device = resolve_device(device)
        if (getattr(config, "data_parallel", False) and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError("data_parallel over more than one card is not ported yet")
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
        self.step_launches = {k: dict.fromkeys(_build.LAUNCHES, 0) for k in STEP_KINDS}
        self.time_steps = False
        self.step_ms = {k: [] for k in STEP_KINDS}
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

    @property
    def ada_aug_p(self):
        return float(self.ada_state["p"])

    @property
    def r_t_stat(self):
        return float(self.ada_state["r_t"])

    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def _step(self, kind):
        """One step's profiler range, launch counts and (if asked) time."""
        before = dict(_build.LAUNCHES)
        if self.time_steps:
            self._sync()
            t0 = time.perf_counter()
        with record_function(PROFILE_RANGES[kind]):
            yield
        if self.time_steps:
            self._sync()
            self.step_ms[kind].append((time.perf_counter() - t0) * 1e3)
        for k, n in _build.LAUNCHES.items():
            self.step_launches[kind][k] += n - before[k]

    def _apply(self, kind, optimizer, loss, tensors):
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]
        if self.keep_first_grads and kind not in self.first_grads:
            self.first_grads[kind] = [g.detach().clone() for g in grads]
        optimizer.step(grads)

    def _augment(self, img, transform):
        if not self.use_aug:
            return img
        with record_function("gan.ada"):
            return augment(img, transform_matrix=transform,
                           warp_impl=self._ada_warp_impl, ops=self.ops)[0]

    def _disc(self, x):
        return discriminator_forward(self.netD, x, self.ops)

    def _synth(self, z, noise, inject_index):
        """Style-mixed synthesis from z (mapping each z) with the noise
        maps passed in."""
        ws = [mapping_apply(self.netG, zz, self.ops) for zz in z]
        img, _ = generator_forward(self.netG, ws, input_is_latent=True,
                                   noise=noise, inject_index=inject_index,
                                   return_latents=True, ops=self.ops)
        return img

    def d_step(self, real, draws):
        """D step: WGAN-GP mixed penalty under 'wgangp' (the 0.25/0.25/0.5
        combination of the JAX trainer), the ADA controller after it."""
        with self._step("d"):
            with torch.no_grad():
                fake = self._synth(draws.z, draws.d_noise, draws.inject_index)
                d_fake = self._augment(fake, draws.d_fake_aug)
                d_real = self._augment(real, draws.d_real_aug)
            pred_fake, pred_real = self._disc(d_fake), self._disc(d_real)
            loss_out = self.adversarial_loss(pred_fake, False)
            loss_ref = self.adversarial_loss(pred_real, True)
            if self.config.gan_mode == "wgangp":
                gp, _ = gradient_penalty(self._disc, d_real, d_fake, draws.gp_alpha)
                loss = (loss_out + loss_ref) * 0.25 + gp * 0.5
            else:
                loss = loss_out + loss_ref
            self._apply("d", self.optimizer_d, loss, self.d_tensors)
            if self.tune_ada:
                self.ada_state = ada_update(self.ada_state, pred_real,
                                            self.config.ada_target,
                                            self.config.ada_length, 8)
        return loss.detach(), loss_out.detach(), loss_ref.detach(), fake

    def r1_step(self, real, draws):
        cfg = self.config
        with self._step("r1"):
            penalty, pred = r1_penalty(
                lambda x: self._disc(self._augment(x, draws.r1_aug)), real)
            loss = cfg.r1_lambda / 2 * penalty * cfg.d_reg_every + 0 * pred[0, 0]
            self._apply("r1", self.optimizer_d, loss, self.d_tensors)
        return loss.detach()

    def g_step(self, draws):
        with self._step("g"):
            fake = self._synth(draws.z, draws.g_noise, draws.inject_index)
            pred_fake = self._disc(self._augment(fake, draws.g_aug))
            loss = self.adversarial_loss(pred_fake, True)
            self._apply("g", self.optimizer_g, loss, self.g_tensors)
        return loss.detach()

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
                decay=cfg.ppl_decay)
            self._apply("ppl", self.optimizer_g, cfg.ppl_lambda * cfg.g_reg_every * ppl,
                        self.g_tensors)
        return ppl.detach(), new_mean

    # ------------------------------------------------------------------

    def set_input(self, data_sample=None, iter_no=None, epoch_no=None,
                  latent=None, gen_args=None, draws=None):
        """Stage a training batch (ref bagganhq.py:155-205) and the
        iteration's draws: ``draws`` if given, else drawn from the trainer's
        generator at the current ADA p."""
        self.iter_no = iter_no if iter_no is not None else self.iter_no
        self.epoch_no = epoch_no
        cfg = self.config
        if data_sample is not None:
            img = data_sample["ct"] if isinstance(data_sample, dict) else data_sample
            self.ref_image = torch.as_tensor(img, dtype=torch.float32).to(
                self.device).contiguous()
        else:
            self.ref_image = torch.zeros(cfg.batch_size, cfg.image_size, cfg.image_size,
                                         getattr(cfg, "num_channels", 3), device=self.device)
        self.bsize = self.ref_image.shape[0]
        if draws is None:
            p = self.ada_aug_p if getattr(cfg, "augment", False) else 0.0
            draws = draw_step_inputs(self.generator, cfg, self.gen_meta, self.bsize,
                                     self.iter_no, p, self.device)
        if latent is not None:
            latent = latent if isinstance(latent, (list, tuple)) else [latent]
            draws = draws._replace(z=list(latent), inject_index=self.gen_meta["n_latent"])
        self.draws = draws
        self.input_latent = draws.z
        self.inject_index = draws.inject_index if len(draws.z) > 1 else None
        self.gen_args = gen_args

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
        d = self.draws
        self.loss_d, self.loss_d_out, self.loss_d_ref, _ = self.d_step(self.ref_image, d)
        if self.iter_no % cfg.d_reg_every == 0:
            self.loss_d_r1 = self.r1_step(self.ref_image, d)
        self.loss_g_gan = self.g_step(d)
        self.loss_g = self.loss_g_gan
        if getattr(cfg, "use_ppl", False) and self.iter_no % cfg.g_reg_every == 0:
            self.loss_g_ppl, self.mean_path_length = self.ppl_step(d)
        self.iter_no += 1

    def optimize_parameters_chunk(self, real_batches):
        raise NotImplementedError("the fused multi-iteration chunk is not ported "
                                  "yet; call set_input + optimize_parameters")

    def update_learning_rate(self, metric=None):
        mult = super().update_learning_rate(metric)
        self.optimizer_g.lr = self._base_lrs[0] * mult
        self.optimizer_d.lr = self._base_lrs[1] * mult
        return mult

    def test(self):
        """No-grad forward for sampling (ref :486-501)."""
        return self.forward()
