"""One-shot segmentation pipeline: setup, train, test (port of
ganecdotes_tpu/pipeline/one_shot_pipeline.py) for the five methods:
hfc_with_swav, hfc_with_simclr, hfc_kmeans (flat or hierarchical, with the
flat or the belief encoding), RepurposeGAN and DatasetGAN.

* load: the StyleGAN2 generator from the reference checkpoint at the model
  config's ``model_path`` (rosinality ``g_ema``), the BagGAN generator of a
  BagGAN config (``models.baggan``), or random weights from the seed;
* setup: load the test latents and labels (``.pt``/``.npy``/``.npz``) or
  synthesise pseudo-labelled samples, then synthesise the one-shot sample
  (the p-car / p-horse family: with the per-layer noises at the config's
  ``sample_noises`` and without truncation); in online mode without a fed
  latent, the one-shot label is painted in ``gui.labeller.OneShotLabellerGUI``
  (matplotlib and cv2);
* train: the one-shot features of the method (the SwAV or SimCLR
  projection, pretrained or loaded from ``swav_params.npz`` /
  ``simclr_params.npz``; the k-means encoding of the clusterers fitted or
  loaded from ``clusterer_layer_{n}.npz`` (and ``beliefs.npz``); the raw
  nearest-up concat for the two baselines), then the supervised fine-tune
  of the head (``pipeline.trainer``): an FCN or ``Lin`` head, or
  DatasetGAN's pixel classifier with its BatchNorm state;
* test: serve the test set in requests of ``MAX_TEST_BATCH`` through the
  method's folded form (``pipeline.serving``: ``OneShotServer`` and the
  other methods' servers), then score it with
  ``metrics.segmentation``. ``run_tests`` runs three parts in turn:
  ``predict_tests`` (the device part), ``score_tests`` (numpy metrics, the
  CSVs, ``results.npz``) and ``save_test_figures`` (collages, the PD plot
  and TensorBoard images; PIL and matplotlib are imported there only).

The artifacts and their layout are the JAX pipeline's.
"""

import csv
import functools
import importlib.util
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ganecdotes_torch import resolve_device
from ganecdotes_torch.metrics.segmentation import (
    get_bb_dice,
    get_bb_iou,
    get_bin_iou,
    get_iou_vs_pd_curve,
    get_mask_dice,
    get_mask_iou,
    get_pd_at_iou_threshold,
    get_weighted_iou,
    plot_iou_vs_pd_curve,
)
from ganecdotes_torch.models.baggan import load_baggan_generator
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_params,
    load_torch_checkpoint,
)
from ganecdotes_torch.models.stylegan2.generator import (
    Generator,
    generator_forward,
    make_noise,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.interp import resize_nearest
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.parallel.mesh import data_parallel, make_mesh
from ganecdotes_torch.pipeline.serving import (
    ConcatServer,
    KMeansServer,
    OneShotServer,
    PixelClassifierServer,
    SimCLRServer,
)
from ganecdotes_torch.selfsup.embed import _conv3x3, pixel_feature_maps
from ganecdotes_torch.selfsup.heads import (
    init_one_shot_segmentor,
    init_pixel_classifier,
    one_shot_segmentor_apply,
    pixel_classifier_apply,
    segmentor_out_channels,
)
from ganecdotes_torch.selfsup.kmeans import HFCPreprocessor
from ganecdotes_torch.selfsup.lars import tree_map
from ganecdotes_torch.selfsup.simclr import SimCLRClustering
from ganecdotes_torch.selfsup.swav import SwAVClustering
from ganecdotes_torch.utils.util import get_logger, load_config
from ganecdotes_torch.utils.visualization import (
    create_pil_collage,
    sample_label_colors,
    visualize_label_mask,
)

MAX_TEST_BATCH = 8


def _load_tensor(path):
    """Latents or labels saved as torch ``.pt`` or numpy ``.npz``/``.npy``."""
    if path.endswith(".pt"):
        t = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(t, (tuple, list)):
            return tuple(np.asarray(x) for x in t)
        return np.asarray(t)
    data = np.load(path, allow_pickle=False)
    if hasattr(data, "files"):
        return np.asarray(data[data.files[0]])
    return np.asarray(data)


def _resize_mask(mask, size):
    """(h, w) integer mask -> (size, size) int64 by nearest, through float32."""
    t = torch.from_numpy(np.asarray(mask, dtype=np.float32))[None, :, :, None]
    return resize_nearest(t, size)[0, :, :, 0].numpy().astype(np.int64)


def _write_table_csv(path, table, classes):
    """``DataFrame(table, columns=classes).to_csv(path)``'s layout: an index
    column with an empty header, then one column per class."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(classes))
        for i, row in enumerate(table):
            w.writerow([i] + [float(v) for v in row])


class OneShotPipeline:
    """The JAX ``OneShotPipeline``'s blocks.

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. ``ops`` is ``KERNELS`` or
    ``PLAIN``. Random numbers (the generator's weights, the mean latent, the
    synthesised samples, the head's init) come in that order from one
    ``torch.Generator`` seeded with ``seed``; ``gen`` (a port ``Generator``)
    and ``mean_latent`` may be carried in instead of drawn, and
    ``segmentor_init_params`` / ``segmentor_init_state`` (set before the
    train block) start the fine-tune from given weights.

    ``finetune_conv`` is how the fine-tune computes an FCN head's first conv:
    "cudnn" (``F.conv2d``) or "matmul" (``embed._conv3x3``, one matmul over
    the 9 taps and 9 shifted adds); the default is "matmul" for a head whose
    input is wider than ``MATMUL_CONV_MIN_IN`` channels (RepurposeGAN's
    5376-wide concat), "cudnn" otherwise.
    """

    MATMUL_CONV_MIN_IN = 1024

    def __init__(self, out_dir, exp_name="", model="ffhq-256",
                 segmentor="hfc_kmeans", trainer="supervised", tester="all",
                 mode="offline", inputs="saved", custom=None, device=None,
                 num_test_samples=None, seed=42, ops=KERNELS, gen=None,
                 mean_latent=None):
        self.device = resolve_device(device)
        self.ops = ops
        from ganecdotes_torch.configs import mapper as config_mapper

        self.config_mapper = config_mapper
        self.out_dir = out_dir
        os.makedirs(self.out_dir, exist_ok=True)

        self.start_time = time.strftime("%m%d%Y_%H%M%S", time.localtime())
        self.logfile = os.path.join(
            self.out_dir, f"one_shot_learner_{self.start_time}.log")
        self.logger = get_logger("OneShot", self.logfile)
        self.summary_writer = _TensorBoardShim(
            os.path.join(self.out_dir, "tensorboard", f"run_{self.start_time}"))

        self.model_str = model
        self.seg_str = segmentor
        self.train_str = trainer
        self.test_str = tester
        self.mode = mode
        self.inputs = inputs
        self.exp_name = exp_name
        self.generator = torch.Generator().manual_seed(seed)

        self.logger.info("=" * 80)
        self.logger.info("One-Shot Learning Pipeline for StyleGANs (PyTorch)")
        self.logger.info("=" * 80 + "\n")
        self.logger.info("Loading Configurations ....")
        self.logger.info(self.exp_name)

        self.configs = {
            "model": config_mapper.models[self.model_str],
            "seg": config_mapper.segmentors[self.seg_str],
            "trainer": config_mapper.trainer[self.train_str],
        }
        if custom is not None:
            self.configs.update(custom)
        keys = {"model": model, "seg": segmentor, "trainer": trainer}
        for kind, path in self.configs.items():
            if kind in keys and not os.path.exists(path):
                config_mapper.not_ported(kind, keys[kind], path)

        self.logger.info("Loading Pipeline Blocks ...\n")
        self.load_model(gen, mean_latent)
        self.load_segmentor()
        self.load_trainer()
        self.logger.info("Loading Pipeline Blocks ... Done.")

        self.num_test_samples = num_test_samples
        self.mesh = (make_mesh(device=self.device)
                     if dist.is_initialized() and dist.get_world_size() > 1 else None)

    # ------------------------------------------------------------------

    def load_model(self, gen=None, mean_latent=None):
        """The generator (carried in as ``gen``; else loaded from the model
        config's reference checkpoint, or its BagGAN run's; else random from
        the seed) and the pipeline's mean latent. A loaded generator has the
        widths of its file and draws nothing from the seed."""
        self.logger.info("Loading Pretrained StyleGAN2 Model ... ")
        self.model_config = mc = load_config(self.configs["model"], "model_config")
        if gen is None and mc.is_baggan:
            gen = load_baggan_generator(mc, generator=self.generator,
                                        logger=self.logger)
        elif gen is None:
            path = mc.model_path
            ga = mc.gen_args
            if path and os.path.exists(path):
                gen = load_torch_checkpoint(path, ga["size"],
                                            n_mlp=ga.get("n_mlp", 8))
                self.logger.info(f"Loaded checkpoint: {path}")
            else:
                self.logger.warning(
                    f"Checkpoint not found at {path} - using randomly "
                    "initialized generator weights")
                gen = Generator(**ga, generator=self.generator)
        self.model = gen.to(self.device)

        self.color_map = sample_label_colors(len(mc.classes))
        if mean_latent is None:
            with torch.no_grad():
                mean_latent = _mean_latent(self.model, mc.num_latents_for_mean,
                                           self.generator, self.ops)
        self.mean_latent = from_jax_params(mean_latent, self.device)
        self.logger.info(f"Model Name: {self.model_str}")

    def load_segmentor(self):
        """The segmentor config, and the k-means preprocessor for
        hfc_kmeans (the SSL preprocessors are built by the train block)."""
        self.logger.info("Loading Segmentor Network ... ")
        self.seg_config = load_config(self.configs["seg"], "seg_config")
        self.segmentor_params = None
        self.segmentor_state = None
        self.preprocessor = None
        self.finetune_conv = None
        if self.seg_str == "hfc_kmeans":
            self.preprocessor = HFCPreprocessor(
                model=self.model, model_config=self.model_config,
                out_dir=self.out_dir, logger=self.logger, device=self.device,
                ops=self.ops, **self.seg_config.hfc_prep_args)

    def load_trainer(self):
        self.logger.info("Loading Trainer ... ")
        self.trainer_config = load_config(self.configs["trainer"], "trainer_config")
        for k in dir(self.trainer_config):
            if not k.startswith("__"):
                self.logger.info(f"{k}: {getattr(self.trainer_config, k)}")

    # ------------------------------------------------------------------

    def _ssl_class(self):
        return SwAVClustering if "hfc_with_swav" in self.seg_str else SimCLRClustering

    def _build_ssl_preprocessor(self):
        return self._ssl_class()(
            model=self.model, model_config=self.model_config,
            out_dir=self.out_dir, logger=self.logger, tb=self.summary_writer,
            device=self.device, ops=self.ops, **self.seg_config.hfc_prep_args)

    def get_image_from_latent(self, latent, return_features=False, noise=None,
                              truncate=True):
        """The synthesis of latents w: truncated toward the mean latent
        unless ``truncate`` is False, with ``noise`` (per-layer maps) or the
        generator's fixed buffers."""
        trunc = {}
        if truncate:
            trunc = dict(truncation=self.model_config.truncation,
                         truncation_latent=self.mean_latent)
        with torch.no_grad():
            img, feat = generator_forward(
                self.model, [torch.as_tensor(latent, device=self.device)],
                input_is_latent=True, noise=noise, ops=self.ops, **trunc)
        return (img, feat) if return_features else img

    # ------------------------------------------------------------------

    def _synthesize_samples(self, n):
        """Test data when no latents and labels are found: latents
        style(randn), labels the luminance-quantile classes of their images."""
        self.logger.warning(
            "sample latents/labels not found - synthesizing pseudo-labelled "
            f"samples ({n})")
        mc = self.model_config
        z = torch.randn(n, mc.latent_dim, generator=self.generator)
        with torch.no_grad():
            w = mapping_apply(self.model, z.to(self.device), self.ops)

        imgs = []
        for i in range(0, n, MAX_TEST_BATCH):
            chunk = w[i : i + MAX_TEST_BATCH]
            pad = MAX_TEST_BATCH - chunk.shape[0]
            if pad > 0:  # the ragged tail padded: every request is full
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1)], dim=0)
            img = self.get_image_from_latent(chunk)
            imgs.append(img[: MAX_TEST_BATCH - pad].cpu())
        imgs = resize_nearest(torch.cat(imgs, dim=0), mc.image_size).numpy()
        lum = imgs.mean(axis=-1)
        n_class = len(mc.classes)
        qs = np.quantile(lum, np.linspace(0, 1, n_class + 1)[1:-1])
        labels = np.digitize(lum, qs).astype(np.int64)
        return w.cpu().numpy(), labels

    def run_pipeline(self, input_latent=None, input_noises=None,
                     blocks_to_run=("setup", "train", "test")):
        if "setup" in blocks_to_run:
            self.setup(input_latent, input_noises)
        if "train" in blocks_to_run:
            self.run_trainer()
        if "test" in blocks_to_run:
            self.run_tests()

    def setup(self, input_latent=None, input_noises=None):
        """The setup block: the test set, then the one-shot sample."""
        mc = self.model_config
        if input_latent is not None and self.mode != "online":
            raise ValueError("Cannot feed input latents in offline mode!")

        fed_noise_family = hasattr(mc, "sample_noises")  # p-car, p-horse
        lat_path, lbl_path = mc.sample_latents, mc.sample_labels
        if os.path.exists(lat_path) and os.path.exists(lbl_path):
            lat = _load_tensor(lat_path)
            if isinstance(lat, tuple) and not fed_noise_family:
                lat = lat[0]
            self.test_latents = np.asarray(lat)
            self.test_labels = np.asarray(_load_tensor(lbl_path))
        else:
            n = self.num_test_samples or 10
            self.test_latents, self.test_labels = self._synthesize_samples(n + 1)

        ind = min(mc.one_shot_ind, self.test_latents.shape[0] - 1)
        self.one_shot_latent = torch.as_tensor(
            self.test_latents[ind, :], dtype=torch.float32, device=self.device)
        if self.test_labels.max() < 1:
            self.test_labels = self.test_labels * 255
        if "p-car" in self.model_str:
            # the LSUN car labels (rows 64..448 of 512): padded to a square
            n, _, w = self.test_labels.shape
            lbl = np.zeros((n, w, w))
            lbl[:, 256 - 192 : 256 + 192, :] = self.test_labels
            self.test_labels = lbl
        self.one_shot_label = torch.as_tensor(
            self.test_labels[ind : ind + 1].astype(np.int64), device=self.device)

        if input_latent is not None:  # online mode, a fed latent
            self.one_shot_latent = torch.as_tensor(
                input_latent, dtype=torch.float32, device=self.device)
            if input_noises is None:
                input_noises = make_noise(self.model.meta,
                                          generator=self.generator)
            self.one_shot_noise = [
                torch.as_tensor(n, dtype=torch.float32, device=self.device)
                for n in input_noises]
        else:
            self.one_shot_noise = self._load_sample_noises()

        one_shot_in = self.one_shot_latent
        if one_shot_in.dim() == 1:
            one_shot_in = one_shot_in[None]
        # the fed-noise family skips truncation here (the test block keeps it)
        self.one_shot_img, self.one_shot_features = self.get_image_from_latent(
            one_shot_in, return_features=True, noise=self.one_shot_noise,
            truncate=not fed_noise_family)

        if self.mode == "online" and input_latent is None:
            from ganecdotes_torch.gui.labeller import OneShotLabellerGUI

            self.logger.info("Initializing GUI ...")
            self.labeller = OneShotLabellerGUI(
                self.transform_im_for_gui(self.one_shot_img), mc.classes)
            # (1, 1, H, W) uint8, as the JAX pipeline takes it; a copy of
            # the painter's labels, which later strokes change
            self.one_shot_label = torch.tensor(
                self.labeller.get_labels(), device=self.device)[None]

        if input_latent is None:  # the one-shot sample leaves the test set
            self.test_latents = np.concatenate(
                [self.test_latents[:ind], self.test_latents[ind + 1 :]], 0)
            self.test_labels = np.concatenate(
                [self.test_labels[:ind], self.test_labels[ind + 1 :]], 0)

        if self.num_test_samples is None:
            self.num_test_samples = self.test_labels.shape[0]
        self.num_test_samples = min(self.num_test_samples,
                                    self.test_labels.shape[0])

    def _load_sample_noises(self):
        """The one-shot synthesis's per-layer noises from the model config's
        ``sample_noises``: a file (a list of per-layer maps) or a directory of
        per-layer ``.pt``/``.npy``/``.npz`` files, taken in (length, name)
        order (noise_2 before noise_10); NCHW (B, 1, H, W) maps become NHWC.
        None (the generator's fixed buffers) when the config has no such
        path or nothing is there."""
        path = getattr(self.model_config, "sample_noises", None)
        if not path or not os.path.exists(path):
            if path:
                self.logger.warning(
                    f"sample_noises path not found: {path} - using the "
                    "generator's fixed noise buffers")
            return None
        if os.path.isdir(path):
            files = sorted((f for f in os.listdir(path)
                            if f.endswith((".pt", ".npy", ".npz"))),
                           key=lambda f: (len(f), f))
            arrs = [_load_tensor(os.path.join(path, f)) for f in files]
        else:
            loaded = _load_tensor(path)
            arrs = list(loaded) if isinstance(loaded, (tuple, list)) else [
                np.asarray(a) for a in loaded]
        noises = []
        for a in arrs:
            a = np.asarray(a, dtype=np.float32)
            if a.ndim == 3:
                a = a[None]
            if a.ndim == 4 and a.shape[1] == 1 and a.shape[-1] != 1:
                a = a.transpose(0, 2, 3, 1)  # NCHW -> NHWC
            noises.append(torch.as_tensor(a, device=self.device))
        return noises or None

    # ------------------------------------------------------------------

    def _extract_one_shot_features(self):
        """The one-shot sample's training features, by method: the raw
        nearest-up concat of the first ``n_layers`` maps (the baselines), the
        k-means encoding (the clusterers fitted first with ``train_hfc``),
        or the SwAV / SimCLR projection (pretrained first with
        ``train_hfc``, or when no params were loaded)."""
        if self.seg_str in ("repurposegan", "datasetgan"):
            return pixel_feature_maps(self.one_shot_features,
                                      n_layers=self.seg_config.n_layers)
        if self.seg_str == "hfc_kmeans":
            if self.seg_config.train_hfc:
                self.preprocessor.train_hfc_model(self.one_shot_latent)
            feats, _ = self.preprocessor.predict_hfc_vectors(self.one_shot_latent)
            return feats
        if not isinstance(self.preprocessor, self._ssl_class()):
            self.preprocessor = self._build_ssl_preprocessor()
        pre = self.preprocessor
        if isinstance(pre, SwAVClustering):
            if self.seg_config.train_hfc or pre.ssl_params is None:
                pre.preprocess(self.one_shot_latent)
            return pre.predict_swav_codes(self.one_shot_latent)[0]
        if self.seg_config.train_hfc or pre.params is None:
            pre.preprocess(self.one_shot_latent)
        return pre.predict_simclr_codes(self.one_shot_latent)[0]

    def run_trainer(self):
        if self.train_str != "supervised":
            raise ValueError(f"unknown trainer {self.train_str}")

        self.one_shot_train_features = self._extract_one_shot_features().detach()

        n_class = len(self.model_config.classes)
        in_ch = int(self.one_shot_train_features.shape[-1])
        self.seg_size = self.seg_config.seg_args.get("size", "S")
        self._seg_is_mlp = self.seg_str == "datasetgan"
        n_out = (n_class if self._seg_is_mlp
                 else segmentor_out_channels(n_class, self.seg_size))
        top = int(self.one_shot_label.max())
        if top >= n_out:
            # the reference's cross entropy refuses such a target; the JAX
            # package's reports a NaN loss and trains on the others
            raise ValueError(
                f"the one-shot label reaches class {top}, but the "
                f"{self.seg_size!r} head outputs {n_out} channels for the "
                f"model's {n_class} classes")
        state = None
        if self._seg_is_mlp:
            init, state = init_pixel_classifier(in_ch, n_class,
                                                generator=self.generator)
        else:
            init = init_one_shot_segmentor(in_ch, n_class, self.seg_size,
                                           generator=self.generator)
        # start the fine-tune from explicit weights when given (a parity
        # test carries the JAX head's init, and the MLP's BN state, in here)
        if getattr(self, "segmentor_init_params", None) is not None:
            init = self.segmentor_init_params
        if getattr(self, "segmentor_init_state", None) is not None:
            state = self.segmentor_init_state
        self.segmentor_params = tree_map(lambda t: t.detach().clone(),
                                         from_jax_params(init, self.device))
        self.segmentor_state = (None if state is None
                                else from_jax_params(state, self.device))
        if self.finetune_conv is None:
            self.finetune_conv = ("matmul" if in_ch > self.MATMUL_CONV_MIN_IN
                                  else "cudnn")
        self._train_segmentor()

    def _train_segmentor(self):
        """The supervised fine-tune, in chunks of ``print_freq`` epochs; a
        plateau scheduler steps once per chunk on its last loss."""
        from ganecdotes_torch.pipeline.trainer import make_supervised_finetune

        tc = self.trainer_config
        lambdas = list(tc.lambdas)
        lam_sum = sum(lambdas)
        loss_terms = [(lam / lam_sum, self.config_mapper.losses[name])
                      for name, lam in zip(tc.losses, lambdas)]
        sched = self.config_mapper.lr_scheduler[tc.scheduler_type](
            **tc.scheduler_args)
        stateful_sched = hasattr(sched, "step")
        size = self.seg_size
        first_conv = _conv3x3 if self.finetune_conv == "matmul" else None

        if self._seg_is_mlp:
            # the BN running stats ride through every chunk; eval-mode
            # serving normalises with the trained ones
            def apply_fn(params, state, x):
                return pixel_classifier_apply(params, state, x, train=True)
        else:
            def apply_fn(params, state, x):
                return one_shot_segmentor_apply(params, x, size,
                                                first_conv), state

        chunk = max(1, int(tc.print_freq))
        optimizer, run_chunk = make_supervised_finetune(
            apply_fn, loss_terms, self.model_config.image_size, tc.lr,
            betas=(tc.beta1, tc.beta2),
            lr_sched=None if stateful_sched else sched,
            stateful_sched=stateful_sched)
        opt_state = optimizer.init(self.segmentor_params)

        features = self.one_shot_train_features
        label = self.one_shot_label
        state = self.segmentor_state if self._seg_is_mlp else ()
        # (epochs done, loss, host seconds of the chunk) per chunk
        self.finetune_log = []
        start = time.perf_counter()
        done = 0
        while done < tc.num_epochs:
            n = min(chunk, tc.num_epochs - done)
            t0 = time.perf_counter()
            self.segmentor_params, opt_state, state, loss = run_chunk(
                self.segmentor_params, opt_state, state, features, label,
                done, n)
            loss = float(loss)
            done += n
            self.finetune_log.append((done, loss, time.perf_counter() - t0))
            if stateful_sched:
                opt_state.lr = tc.lr * sched.step(loss)
            self.logger.info(
                f"{done:5}-th epoch | loss: {loss:6.4f} | "
                f"time: {time.perf_counter() - start:6.1f}sec")
        for p in opt_state.params:
            p.requires_grad_(False)
        if self._seg_is_mlp:
            self.segmentor_state = state
        self.logger.info("******* Training Complete ********")

    # ------------------------------------------------------------------

    def transform_im_for_gui(self, im):
        """Images in [-1, 1] (a tensor on any device) -> numpy in [0, 1]."""
        return np.clip(im.detach().cpu().numpy(), -1.0, 1.0) * 0.5 + 0.5

    def make_server(self):
        """The method's server (``pipeline.serving``) over the trained
        weights, on the pipeline's op set, in the model config's
        ``inference_dtype`` (float32 unless it says 'bfloat16'; the training
        path stays float32, as in JAX)."""
        dtype = getattr(self.model_config, "inference_dtype", None)
        if "hfc_with_swav" in self.seg_str:
            return OneShotServer(
                self.model_config, self.seg_config, device=self.device,
                gen=self.model, ssl_params=self.preprocessor.ssl_params,
                seg_params=self.segmentor_params, mean_latent=self.mean_latent,
                ops=self.ops, dtype=dtype)
        args = (self.model, self.mean_latent, self.model_config.truncation,
                self.segmentor_params, self.seg_size)
        kw = dict(ops=self.ops, dtype=dtype)
        sc = self.seg_config
        if self.seg_str == "repurposegan":
            return ConcatServer(*args, n_layers=sc.n_layers, **kw)
        if self.seg_str == "datasetgan":
            return PixelClassifierServer(*args, state=self.segmentor_state,
                                         n_layers=sc.n_layers, **kw)
        if self.seg_str == "hfc_with_simclr":
            sa = self.preprocessor.simclr_args
            return SimCLRServer(*args, params=self.preprocessor.params,
                                hlen=sa["hlen"], interp=sa.get("hf_interp", "nearest"),
                                **kw)
        return KMeansServer(*args, pre=self.preprocessor, **kw)

    def _make_infer_fn(self):
        """The test block's request: generate -> the method's folded form
        -> argmax, on latents w; ``self.server`` holds the method's server
        (``make_server``)."""
        self.server = self.make_server()
        return functools.partial(self.server.serve, input_is_latent=True)

    def run_tests(self):
        """The test block: prediction, scoring, then the figures (under
        data parallel, scored and written by rank 0 only)."""
        self.predict_tests()
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        results = self.score_tests()
        self.save_test_figures()
        return results

    def predict_tests(self):
        """Serve the test latents in requests of ``MAX_TEST_BATCH`` (the
        ragged tail padded) and save ``label_predictions.npy``.

        In a process group of more than one rank (``torchrun``,
        ``parallel.mesh.distributed_init``) each request of ranks x
        ``MAX_TEST_BATCH // ranks`` latents is split over the ranks, with
        rank 0's trained head, and gathered (JAX's sharded test batch),
        by ``parallel.mesh.data_parallel``."""
        self.test_dir = os.path.join(self.out_dir, "tests")
        self.test_img_dir = os.path.join(self.test_dir, "images")
        os.makedirs(self.test_img_dir, exist_ok=True)

        mesh = self.mesh
        batch = MAX_TEST_BATCH
        if mesh is None:
            infer = self._make_infer_fn()
        else:
            batch = mesh.size * max(1, MAX_TEST_BATCH // mesh.size)

            def make_infer(params):  # rank 0's trained head, on every rank
                self.segmentor_params = params
                return self._make_infer_fn()

            infer = data_parallel(mesh, make_infer, self.segmentor_params)
        pred_labels, test_images, inference_times = [], [], []
        # (offset, img 0, cluster map 0 or None, labels 0)
        self._request_firsts = []
        n = self.num_test_samples
        for bs in range(0, n, batch):
            t0 = time.perf_counter()
            chunk_lat = self.test_latents[bs : bs + batch]
            pad = batch - chunk_lat.shape[0]
            if pad > 0:
                chunk_lat = np.concatenate(
                    [chunk_lat, np.repeat(chunk_lat[-1:], pad, axis=0)], 0)
            # z0: sample 0's cluster map (under data parallel, rank 0's)
            img, pred, z0 = infer(torch.as_tensor(chunk_lat))
            pred = pred.cpu()
            inference_times.append(time.perf_counter() - t0)
            pred_labels.append(pred.numpy())
            img = img.float().cpu()  # exact for a bf16 image
            test_images.append(img.numpy())
            self._request_firsts.append(
                (bs, img[0].numpy(), None if z0 is None else z0[0].cpu().numpy(),
                 pred[0].numpy()))

        self.pred_labels = np.concatenate(pred_labels, axis=0)[:n]
        self.test_images = np.concatenate(test_images, axis=0)[:n]
        if mesh is None or mesh.rank == 0:
            np.save(os.path.join(self.test_dir, "label_predictions.npy"),
                    self.pred_labels)
        self.inference_times = inference_times
        self.mean_inference_time = float(np.mean(inference_times))
        self.logger.info(f"Mean Inference Time: {self.mean_inference_time}")
        return self.pred_labels

    def score_tests(self):
        """The metrics of ``predict_tests``' labels (numpy): the IoU, Dice
        and PD tables, ``mask_iou_results.csv`` / ``bb_iou_results.csv`` and
        ``results.npz``."""
        size = self.model_config.image_size
        classes = self.model_config.classes
        results = {}
        self._test_ims = ims = [[], [], []]
        n = self.num_test_samples
        for i in range(n):
            input_im = resize_nearest(
                torch.from_numpy(self.test_images[i : i + 1]), size)[0].numpy()
            gt_mask = _resize_mask(self.test_labels[i], size)
            pred_mask = _resize_mask(self.pred_labels[i], size)
            ims[0].append(input_im)
            ims[1].append(gt_mask)
            ims[2].append(pred_mask)

            if self.test_str in ["iou", "all", "iou_vs_pd"]:
                mask_iou = {c: get_mask_iou(gt_mask, pred_mask, k)
                            for k, c in enumerate(classes)}
                bb_iou = {c: get_bb_iou(gt_mask, pred_mask, k)
                          for k, c in enumerate(classes)}
                w_iou = get_weighted_iou(gt_mask, mask_iou, classes)
                results.setdefault("mask_iou", []).append(mask_iou)
                results.setdefault("bb_iou", []).append(bb_iou)
                results.setdefault("w_iou", []).append(w_iou)
                # the last sample's value, as the JAX pipeline keeps it
                results["bin_iou"] = get_bin_iou(gt_mask, pred_mask)

            if self.test_str in ["dice", "all"]:
                results.setdefault("mask_dice", []).append(
                    {c: get_mask_dice(gt_mask, pred_mask, k)
                     for k, c in enumerate(classes)})
                results.setdefault("bb_dice", []).append(
                    {c: get_bb_dice(gt_mask, pred_mask, k)
                     for k, c in enumerate(classes)})

        if self.test_str in ["iou", "all", "iou_vs_pd"]:
            mask_table = np.array([[s[k] for k in classes]
                                   for s in results["mask_iou"]])
            bb_table = np.array([[s[k] for k in classes]
                                 for s in results["bb_iou"]])
            # per class, its column of per-sample IoUs
            mask_iou_columns = {c: mask_table[:, k] for k, c in enumerate(classes)}
            if self.test_str in ["iou", "all"]:
                _write_table_csv(
                    os.path.join(self.test_dir, "mask_iou_results.csv"),
                    mask_table, classes)
                _write_table_csv(
                    os.path.join(self.test_dir, "bb_iou_results.csv"),
                    bb_table, classes)
                class_means = mask_table.mean(axis=0)
                self.logger.info("\nMask IoU Results:\n" + "\n".join(
                    f"{c}\t{v}" for c, v in zip(classes, class_means)))
                self.mean_mask_iou = float(class_means.mean())
                self.logger.info(f"\nMean Mask IoU:\n{self.mean_mask_iou}")
                self.logger.info(
                    f"\nWeighted IoU Results:\n{np.mean(results['w_iou'])}")
                self.logger.info(f"FG IoU: {results['bin_iou']}")

        if self.test_str in ["iou_vs_pd", "all"]:
            pd_scores = get_pd_at_iou_threshold(mask_iou_columns, classes, 0.5)
            results["pd"] = pd_scores
            self.logger.info("Mean PD at IoU=0.5:")
            for k, v in pd_scores.items():
                self.logger.info(f"{k}: \t{v}")
            self.logger.info(f"Mean PD:{np.mean([v for v in pd_scores.values()])}")
            results["iou_pd_curve"] = get_iou_vs_pd_curve(mask_iou_columns,
                                                          classes)

        np.savez_compressed(
            os.path.join(self.test_dir, "results.npz"),
            **{k: np.asarray(v, dtype=object) for k, v in results.items()})
        self.test_results = results
        return results

    # ------------------------------------------------------------------

    def save_test_figures(self):
        """Each request's cluster-map figure and TensorBoard images, each
        sample's collages, the PD curve and (tester 'demo') the demo grid.
        The figures need matplotlib and the collages PIL; where one is not
        installed (a headless card machine) its pictures are skipped with a
        warning: the metrics and their files do not depend on them."""
        have_mpl, have_pil = (importlib.util.find_spec(m) is not None
                              for m in ("matplotlib", "PIL"))
        for name, have in (("matplotlib", have_mpl), ("PIL", have_pil)):
            if not have:
                self.logger.warning(f"{name} is not installed: the test "
                                    "pictures that need it are not written")
        for bs, img0, cluster0, pred0 in self._request_firsts:
            img0 = img0 / max(float(np.abs(img0).max()), 1e-12)
            if cluster0 is not None:  # the SSL methods' cluster map
                cluster0 = cluster0.astype(np.float32)
                cluster0 = cluster0 / max(float(cluster0.max()), 1e-12)
                if have_mpl:
                    self._save_test_pred_figure(img0, cluster0, bs)
                self.summary_writer.add_image(
                    "one_shot/test_image", np.clip(img0 * 0.5 + 0.5, 0, 1),
                    step=bs, dataformats="HWC")
                self.summary_writer.add_image(
                    "one_shot/swav_output", cluster0, step=bs, dataformats="HW")
            pred0 = pred0.astype(np.float32)
            self.summary_writer.add_image(
                "one_shot/predictions", pred0 / max(float(pred0.max()), 1.0),
                step=bs, dataformats="HW")

        cmap = self.color_map
        for i, (input_im, gt_mask, pred_mask) in enumerate(
                zip(*self._test_ims) if have_pil else ()):
            # create_pil_collage min/max-normalises non-uint8 inputs
            disp = np.clip(input_im, -1, 1)
            create_pil_collage(
                [disp, np.uint8(visualize_label_mask(gt_mask, cmap) * 255),
                 np.uint8(visualize_label_mask(pred_mask, cmap) * 255)],
                os.path.join(self.test_img_dir, f"sample_{i}_pred.png"))
            create_pil_collage(
                [disp,
                 np.uint8(visualize_label_mask(
                     (gt_mask > 0).astype(np.int64), cmap) * 255),
                 np.uint8(visualize_label_mask(
                     (pred_mask > 0).astype(np.int64), cmap) * 255)],
                os.path.join(self.test_img_dir, f"sample_{i}_pred_fg.png"))

        if self.test_str in ["iou_vs_pd", "all"] and have_mpl:
            classes = self.model_config.classes
            plot_iou_vs_pd_curve(
                self.test_results["iou_pd_curve"], classes + ["Mean"],
                os.path.join(self.test_dir, "iou_vs_pd_curve.png"),
                self.model_str)
        if self.test_str == "demo" and have_pil:
            self._save_demo_collage(self._test_ims)

    def _save_test_pred_figure(self, img01, cluster01, bs):
        """Cluster map and image side by side."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        plt.figure()
        plt.subplot(121)
        plt.imshow(cluster01, cmap="jet")
        plt.subplot(122)
        plt.imshow(np.clip(img01 * 0.5 + 0.5, 0, 1))
        plt.savefig(os.path.join(self.out_dir, f"test_pred_{bs}.png"))
        plt.close()

    def _save_demo_collage(self, ims):
        """The one-shot sample and every test prediction in a 2 x (n + 1)
        grid."""
        size = self.model_config.image_size
        one_shot_in = self.one_shot_latent
        if one_shot_in.dim() == 1:
            one_shot_in = one_shot_in[None]
        input_im = resize_nearest(self.get_image_from_latent(one_shot_in).cpu(),
                                  size)[0].numpy()
        one_shot_mask = _resize_mask(self.one_shot_label[0].cpu().numpy(), size)
        mask_in = np.uint8(visualize_label_mask(one_shot_mask, self.color_map) * 255)
        row_ims = [np.clip(im, -1, 1) for im in ims[0]]
        row_preds = [np.uint8(visualize_label_mask(p, self.color_map) * 255)
                     for p in ims[2]]
        n = len(row_ims)
        create_pil_collage([np.clip(input_im, -1, 1)] + row_ims + [mask_in] + row_preds,
                           os.path.join(self.test_dir, "demo.png"), (2, n + 1))


class _TensorBoardShim:
    """Scalar and image logging without a hard tensorboard dependency: torch's
    SummaryWriter where tensorboard is installed, else an in-memory record."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.records = {}
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(log_dir, exist_ok=True)
            self._writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def add_scalar(self, tag, value, step=None):
        self.records.setdefault(tag, []).append((step, float(value)))
        if self._writer:
            self._writer.add_scalar(tag, value, step)

    def add_image(self, tag, img, step=None, dataformats=None):
        self.records.setdefault(tag, []).append((step, np.asarray(img).shape))
        if self._writer:
            img = np.asarray(img)
            if dataformats is None:
                dataformats = "HW" if img.ndim == 2 else "HWC"
            self._writer.add_image(tag, img, step, dataformats=dataformats)
