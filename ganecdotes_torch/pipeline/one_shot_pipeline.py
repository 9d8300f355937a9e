"""One-shot segmentation pipeline: setup, train, test (port of
ganecdotes_tpu/pipeline/one_shot_pipeline.py, the hfc_with_swav path).

* setup: load the test latents and labels (``.pt``/``.npy``/``.npz``) or
  synthesise pseudo-labelled samples, then synthesise the one-shot sample;
* train: the one-shot SwAV features (``SwAVClustering``, pretrained or
  loaded from ``swav_params.npz``), then the supervised fine-tune of the
  FCN head (``pipeline.trainer``);
* test: serve the test set in requests of ``MAX_TEST_BATCH`` through the
  folded projection + head (``OneShotServer.serve``), then score it with
  ``metrics.segmentation``. ``run_tests`` runs three parts in turn:
  ``predict_tests`` (the device part), ``score_tests`` (numpy metrics, the
  CSVs, ``results.npz``) and ``save_test_figures`` (collages, the PD plot
  and TensorBoard images; PIL and matplotlib are imported there only).

The artifacts and their layout are the JAX pipeline's. What the port does
not run yet raises ``NotImplementedError`` naming its ROADMAP item: the
other segmentation methods, the GUI labelling of online mode, the BagGAN
generator, reference checkpoints, and the model configs not copied yet
(the p-car / ``sample_noises`` family among them).
"""

import csv
import functools
import importlib.util
import os
import time

import numpy as np
import torch

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
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import (
    Generator,
    generator_forward,
    make_noise,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.interp import resize_nearest
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.pipeline.serving import OneShotServer
from ganecdotes_torch.selfsup.heads import (
    DILATIONS,
    init_one_shot_segmentor,
    one_shot_segmentor_apply,
)
from ganecdotes_torch.selfsup.lars import tree_map
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
    """The JAX ``OneShotPipeline``'s blocks for hfc_with_swav.

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs every op's plain version. ``ops`` is ``KERNELS`` or
    ``PLAIN``. Random numbers (the generator's weights, the mean latent, the
    synthesised samples, the head's init) come in that order from one
    ``torch.Generator`` seeded with ``seed``; ``gen`` (a port ``Generator``)
    and ``mean_latent`` may be carried in instead of drawn.
    """

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

    # ------------------------------------------------------------------

    def load_model(self, gen=None, mean_latent=None):
        """The StyleGAN2 generator (random from the seed, or carried in) and
        the pipeline's mean latent."""
        self.logger.info("Loading Pretrained StyleGAN2 Model ... ")
        self.model_config = mc = load_config(self.configs["model"], "model_config")
        if mc.is_baggan:
            raise NotImplementedError(
                "the BagGAN generator in the one-shot pipeline is not ported "
                "yet: ROADMAP §1 item 6")
        if hasattr(mc, "sample_noises") or "p-car" in self.model_str:
            raise NotImplementedError(
                "the p-car / sample_noises model family is not ported yet: "
                "ROADMAP §1 item 9")
        path = mc.model_path
        if path and os.path.exists(path):
            raise NotImplementedError(
                f"loading the reference checkpoint {path} is not ported yet: "
                "ROADMAP §1 item 5")
        if gen is None:
            self.logger.warning(
                f"Checkpoint not found at {path} - using randomly "
                "initialized generator weights")
            gen = Generator(**mc.gen_args, generator=self.generator)
        self.model = gen.to(self.device)

        self.color_map = sample_label_colors(len(mc.classes))
        if mean_latent is None:
            with torch.no_grad():
                mean_latent = _mean_latent(self.model, mc.num_latents_for_mean,
                                           self.generator, self.ops)
        self.mean_latent = from_jax_params(mean_latent, self.device)
        self.logger.info(f"Model Name: {self.model_str}")

    def load_segmentor(self):
        self.logger.info("Loading Segmentor Network ... ")
        if "hfc_with_swav" not in self.seg_str:
            raise NotImplementedError(
                f"the {self.seg_str} method is not ported yet: ROADMAP §1 item 4")
        self.seg_config = load_config(self.configs["seg"], "seg_config")
        self.segmentor_params = None
        self.preprocessor = None

    def load_trainer(self):
        self.logger.info("Loading Trainer ... ")
        self.trainer_config = load_config(self.configs["trainer"], "trainer_config")
        for k in dir(self.trainer_config):
            if not k.startswith("__"):
                self.logger.info(f"{k}: {getattr(self.trainer_config, k)}")

    # ------------------------------------------------------------------

    def _build_ssl_preprocessor(self):
        return SwAVClustering(
            model=self.model, model_config=self.model_config,
            out_dir=self.out_dir, logger=self.logger, tb=self.summary_writer,
            device=self.device, ops=self.ops, **self.seg_config.hfc_prep_args)

    def get_image_from_latent(self, latent, return_features=False, noise=None):
        with torch.no_grad():
            img, feat = generator_forward(
                self.model, [torch.as_tensor(latent, device=self.device)],
                input_is_latent=True, truncation=self.model_config.truncation,
                truncation_latent=self.mean_latent, noise=noise, ops=self.ops)
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
        if self.mode == "online" and input_latent is None:
            raise NotImplementedError(
                "GUI labelling in online mode is not ported yet: ROADMAP §1 "
                "item 7")

        lat_path, lbl_path = mc.sample_latents, mc.sample_labels
        if os.path.exists(lat_path) and os.path.exists(lbl_path):
            lat = _load_tensor(lat_path)
            if isinstance(lat, tuple):
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
        self.one_shot_label = torch.as_tensor(
            self.test_labels[ind : ind + 1].astype(np.int64), device=self.device)

        self.one_shot_noise = None
        if input_latent is not None:  # online mode, a fed latent
            self.one_shot_latent = torch.as_tensor(
                input_latent, dtype=torch.float32, device=self.device)
            if input_noises is None:
                input_noises = make_noise(self.model.meta,
                                          generator=self.generator)
            self.one_shot_noise = [
                torch.as_tensor(n, dtype=torch.float32, device=self.device)
                for n in input_noises]

        one_shot_in = self.one_shot_latent
        if one_shot_in.dim() == 1:
            one_shot_in = one_shot_in[None]
        self.one_shot_img, self.one_shot_features = self.get_image_from_latent(
            one_shot_in, return_features=True, noise=self.one_shot_noise)

        if input_latent is None:  # the one-shot sample leaves the test set
            self.test_latents = np.concatenate(
                [self.test_latents[:ind], self.test_latents[ind + 1 :]], 0)
            self.test_labels = np.concatenate(
                [self.test_labels[:ind], self.test_labels[ind + 1 :]], 0)

        if self.num_test_samples is None:
            self.num_test_samples = self.test_labels.shape[0]
        self.num_test_samples = min(self.num_test_samples,
                                    self.test_labels.shape[0])

    # ------------------------------------------------------------------

    def _extract_one_shot_features(self):
        """The one-shot sample's SwAV projection (the training features)."""
        if not isinstance(self.preprocessor, SwAVClustering):
            self.preprocessor = self._build_ssl_preprocessor()
        if self.seg_config.train_hfc or self.preprocessor.ssl_params is None:
            self.preprocessor.preprocess(self.one_shot_latent)
        feats, _ = self.preprocessor.predict_swav_codes(self.one_shot_latent)
        return feats

    def run_trainer(self):
        if self.train_str != "supervised":
            raise ValueError(f"unknown trainer {self.train_str}")

        self.one_shot_train_features = self._extract_one_shot_features().detach()

        n_class = len(self.model_config.classes)
        in_ch = int(self.one_shot_train_features.shape[-1])
        self.seg_size = self.seg_config.seg_args.get("size", "S")
        if self.seg_size not in DILATIONS:
            raise NotImplementedError(
                f"the {self.seg_size!r} head is not ported yet: ROADMAP §1 item 4")
        init = init_one_shot_segmentor(in_ch, n_class, self.seg_size,
                                       generator=self.generator)
        # start the fine-tune from explicit weights when given (a parity
        # test carries the JAX head's init in here)
        if getattr(self, "segmentor_init_params", None) is not None:
            init = self.segmentor_init_params
        self.segmentor_params = tree_map(lambda t: t.detach().clone(),
                                         from_jax_params(init, self.device))
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

        def apply_fn(params, state, x):
            return one_shot_segmentor_apply(params, x, size), state

        chunk = max(1, int(tc.print_freq))
        optimizer, run_chunk = make_supervised_finetune(
            apply_fn, loss_terms, self.model_config.image_size, tc.lr,
            betas=(tc.beta1, tc.beta2),
            lr_sched=None if stateful_sched else sched,
            stateful_sched=stateful_sched)
        opt_state = optimizer.init(self.segmentor_params)

        features = self.one_shot_train_features
        label = self.one_shot_label
        # (epochs done, loss, host seconds of the chunk) per chunk
        self.finetune_log = []
        start = time.perf_counter()
        done = 0
        while done < tc.num_epochs:
            n = min(chunk, tc.num_epochs - done)
            t0 = time.perf_counter()
            self.segmentor_params, opt_state, _, loss = run_chunk(
                self.segmentor_params, opt_state, (), features, label, done, n)
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
        self.logger.info("******* Training Complete ********")

    # ------------------------------------------------------------------

    def _make_infer_fn(self):
        """The test block's request: generate -> folded projection + head ->
        argmax, on latents w; ``self.server`` holds the server."""
        self.server = OneShotServer(
            self.model_config, self.seg_config, device=self.device,
            gen=self.model, ssl_params=self.preprocessor.ssl_params,
            seg_params=self.segmentor_params, mean_latent=self.mean_latent,
            ops=self.ops)
        return functools.partial(self.server.serve, input_is_latent=True)

    def run_tests(self):
        """The test block: prediction, scoring, then the figures."""
        self.predict_tests()
        results = self.score_tests()
        self.save_test_figures()
        return results

    def predict_tests(self):
        """Serve the test latents in requests of ``MAX_TEST_BATCH`` (the
        ragged tail padded) and save ``label_predictions.npy``."""
        self.test_dir = os.path.join(self.out_dir, "tests")
        self.test_img_dir = os.path.join(self.test_dir, "images")
        os.makedirs(self.test_img_dir, exist_ok=True)

        infer = self._make_infer_fn()
        batch = MAX_TEST_BATCH
        pred_labels, test_images, inference_times = [], [], []
        self._request_firsts = []  # (offset, img 0, cluster map 0, labels 0)
        n = self.num_test_samples
        for bs in range(0, n, batch):
            t0 = time.perf_counter()
            chunk_lat = self.test_latents[bs : bs + batch]
            pad = batch - chunk_lat.shape[0]
            if pad > 0:
                chunk_lat = np.concatenate(
                    [chunk_lat, np.repeat(chunk_lat[-1:], pad, axis=0)], 0)
            img, pred, z0 = infer(torch.as_tensor(chunk_lat))
            pred = pred.cpu()
            inference_times.append(time.perf_counter() - t0)
            pred_labels.append(pred.numpy())
            img = img.cpu()
            test_images.append(img.numpy())
            self._request_firsts.append(
                (bs, img[0].numpy(), z0[0].cpu().numpy(), pred[0].numpy()))

        self.pred_labels = np.concatenate(pred_labels, axis=0)[:n]
        self.test_images = np.concatenate(test_images, axis=0)[:n]
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
