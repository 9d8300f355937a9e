"""Batched generate -> embed -> segment serving, one server per method (port
of ganecdotes_tpu OneShotPipeline._make_infer_fn,
pipeline/one_shot_pipeline.py:563-838, and the request loop of run_tests,
:933-950): ``OneShotServer`` for hfc_with_swav, and ``ConcatServer``
(RepurposeGAN), ``PixelClassifierServer`` (DatasetGAN), ``SimCLRServer``
(hfc_with_simclr) and ``KMeansServer`` (hfc_kmeans), which the pipeline
builds from its trained weights.

A request is a batch of z (B, latent_dim), or of w with
``input_is_latent=True`` (the pipeline's test latents). The server maps z
to w, runs the StyleGAN2 synthesis with truncation toward the mean latent
and the fixed noise buffers, and returns ``(img, labels, z0)`` as the JAX
``infer`` does: ``labels`` (B, H, W) is the argmax of the head's logits,
``z0`` (1, H, W) the argmax of the first sample's projection (its cluster
map).

``serve`` computes the logits as the JAX program does. For a linear SwAV
projection, nearest interpolation and an FCN head, the head's first conv is
folded into the feature pyramid (``infer_folded``,
``embed.project_segment_fcn``): the (B, H, W, nclasses) embedding is
computed for sample 0 only, for ``z0``. ``infer`` keeps the unfused form,
projection then head, as the oracle the folded form is held against
(``serve_unfused`` is its argmax). Every other case (a 1-layer or 2-layer
projection, bilinear interpolation, a ``Lin`` head) has nothing to fold:
its ``serve`` is the unfused form, as the JAX pipeline serves it, with the
2-layer projection's BatchNorm statistics taken per image
(``swav.projection_tail``), so a request of B gives what B requests of 1
give.

Every server's ``serve`` and ``serve_unfused`` return (img, labels, z0);
z0 is None for the methods without a cluster map (RepurposeGAN, DatasetGAN,
hfc_kmeans), as the JAX ``infer`` returns (img, labels) for them.

``dtype`` (the model config's ``inference_dtype``: None, 'float32' or
'bfloat16') runs the synthesis in that type, as the JAX program's
``generator_forward(dtype=...)`` does (one_shot_pipeline.py:563-830): the
mapping and the truncation stay float32, and the projections and heads
downstream run in whatever type the JAX program's casts give them (most
cast their float32 weights to the features' bfloat16; the JAX promotion of
bf16 with a float32 array is float32 here too). The image comes back in
it.
"""

import torch

from ganecdotes_torch import compute_dtype, resolve_device
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import (
    Generator,
    generator_forward,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.selfsup.augmentor import group_features_by_block
from ganecdotes_torch.selfsup.embed import (
    concat_segment_fcn,
    pixel_feature_maps,
    project_feature_maps,
    project_segment_fcn,
)
from ganecdotes_torch.selfsup.heads import (
    DILATIONS,
    init_one_shot_segmentor,
    one_shot_segmentor_apply,
    pixel_classifier_apply,
    pixel_classifier_from_first,
)
from ganecdotes_torch.selfsup.kmeans import hfc_predict_from_features, hfc_segment_fcn
from ganecdotes_torch.selfsup.simclr import (
    simclr_predict_from_features,
    simclr_predict_segment,
)
from ganecdotes_torch.selfsup.swav import init_swav_params, swav_predict_from_features
from ganecdotes_torch.utils import tracing


class OneShotServer:
    """hfc_with_swav serving on one device.

    Weights are random from ``seed`` (one ``torch.Generator`` each for the
    generator, the mean latent, the SwAV params and the head), as the JAX
    pipeline does with ``model_path=None``, unless carried in: ``gen`` (a port
    ``Generator``), ``ssl_params``, ``seg_params`` and ``mean_latent``.

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain path. ``ops`` is ``KERNELS`` (the CUDA
    kernels) or ``PLAIN`` (their plain PyTorch versions, the reference the
    kernels are checked against on the card). ``dtype``: the synthesis'
    type (None: the model config's ``inference_dtype``).
    """

    method = "hfc_with_swav"

    def __init__(self, model_config=None, seg_config=None, *, device=None,
                 seed=0, gen=None, ssl_params=None, seg_params=None,
                 mean_latent=None, ops=KERNELS, dtype=None):
        if model_config is None:
            from ganecdotes_torch.configs.models import ffhq_256 as model_config
        if seg_config is None:
            from ganecdotes_torch.configs.segmentors import (
                hfc_with_swav_ffhq_config as seg_config,
            )
        self.device = resolve_device(device)
        self.ops = ops
        mc, sc = model_config, seg_config
        self.dtype = compute_dtype(dtype or getattr(mc, "inference_dtype", None),
                                   "inference_dtype")
        sa = sc.hfc_prep_args["swav_args"]
        self.hlen = sa["hlen"]
        self.nclasses = sa["nclasses"]
        self.projn_nw = sa["projn_nw"]
        self.interp = sa.get("hf_interp", "nearest")
        self.seg_size = dict(sc.seg_args).get("size", "S")
        # the folded form: exactly the JAX pipeline's case
        self.foldable = (self.seg_size in DILATIONS and self.projn_nw == "linear"
                         and self.interp == "nearest")
        self.truncation = mc.truncation
        self.classes = list(mc.classes)

        def rng(k):
            return torch.Generator().manual_seed(seed * 4 + k)

        if gen is None:
            gen = Generator(**mc.gen_args, generator=rng(0))
        self.gen = gen.to(self.device)
        with torch.inference_mode():
            if mean_latent is None:
                mean_latent = _mean_latent(self.gen, mc.num_latents_for_mean,
                                           rng(1), ops)
            self.mean_latent = from_jax_params(mean_latent, self.device)
        if ssl_params is None:
            ssl_params = init_swav_params(self.hlen, self.nclasses,
                                          sa["nprototypes"], self.projn_nw,
                                          generator=rng(2))
        self.ssl_params = from_jax_params(ssl_params, self.device)
        if seg_params is None:
            seg_params = init_one_shot_segmentor(
                self.nclasses, len(mc.classes), self.seg_size, generator=rng(3))
        self.seg_params = from_jax_params(seg_params, self.device)

    def _w(self, z, input_is_latent):
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        return z if input_is_latent else mapping_apply(self.gen, z, self.ops)

    def _synthesize(self, z, input_is_latent=True):
        return generator_forward(
            self.gen, self._w(z, input_is_latent), input_is_latent=True,
            truncation=self.truncation, truncation_latent=self.mean_latent,
            ops=self.ops, dtype=self.dtype)

    def _project(self, feats):
        return swav_predict_from_features(
            self.ssl_params, feats, self.hlen, self.nclasses, self.projn_nw,
            self.interp)

    def _unfused(self, w):
        return self._unfused_head(*self._synthesize(w))

    def _unfused_head(self, img, feats):
        emb = self._project(feats)
        logits = one_shot_segmentor_apply(self.seg_params, emb, self.seg_size)
        return img, logits, emb[:1]

    def _folded(self, w):
        return self._folded_head(*self._synthesize(w))

    def _folded_head(self, img, feats):
        """The head folded into the pyramid, and sample 0's projection
        (``_unfused_head`` where nothing folds)."""
        if not self.foldable:
            return self._unfused_head(img, feats)
        logits = project_segment_fcn(
            feats, self.ssl_params["projection"][0]["weight"], self.seg_params,
            self.seg_size, hlen=self.hlen)
        return img, logits, self._project([f[:1] for f in feats])

    def infer(self, z, input_is_latent=False):
        """The unfused form: (img (B,H,W,3), logits (B,H,W,C_out), the
        embedding of sample 0 (1,H,W,nclasses)) for a batch of z (or w)."""
        with torch.inference_mode():
            return self._unfused(self._w(z, input_is_latent))

    def serve_unfused(self, z, input_is_latent=False):
        """``infer``'s (img, labels, z0)."""
        return _argmax(*self.infer(z, input_is_latent))

    def infer_folded(self, z, input_is_latent=False):
        """``infer``'s outputs with the head's first conv folded into the
        pyramid: only sample 0's embedding is computed. Where nothing folds
        (``foldable`` False): ``infer``."""
        with torch.inference_mode():
            return self._folded(self._w(z, input_is_latent))

    def serve(self, z, input_is_latent=False):
        """(img, labels, z0) for a batch of z (or w), as the JAX ``infer``
        computes them: ``infer_folded``'s argmaxes. Spans: ``serve.request``
        (a root, an id of its own) over ``serve.synthesis`` (mapping,
        truncation, the generator, to_rgb) and ``serve.segment`` (the folded
        head, sample 0's projection and the argmaxes)."""
        with tracing.span("serve.request"):
            with tracing.span("serve.synthesis"), torch.inference_mode():
                img, feats = self._synthesize(self._w(z, input_is_latent))
            with tracing.span("serve.segment"):
                with torch.inference_mode():
                    out = self._folded_head(img, feats)
                return _argmax(*out)


def _argmax(img, logits, emb0):
    """(img, labels, z0): the argmaxes of the logits and of sample 0's
    embedding (None where the method has none)."""
    return (img, logits.argmax(dim=-1),
            None if emb0 is None else emb0.argmax(dim=-1))


class MethodServer:
    """The request of one of the other methods, from the pipeline's trained
    weights: ``gen`` (a port ``Generator``), the pipeline's ``mean_latent``,
    the model config's ``truncation``, the head's ``seg_params`` and
    ``seg_size``. A subclass computes (logits, z0 or None) from the
    request's latents w in ``_folded`` and ``_unfused``. ``dtype``: the
    synthesis' type (None, 'float32' or 'bfloat16')."""

    def __init__(self, gen, mean_latent, truncation, seg_params, seg_size,
                 ops=KERNELS, dtype=None):
        self.dtype = compute_dtype(dtype, "inference_dtype")
        self.gen = gen
        self.mean_latent = mean_latent
        self.truncation = truncation
        self.seg_params = seg_params
        self.seg_size = seg_size
        self.ops = ops
        self.device = mean_latent.device

    def _w(self, z, input_is_latent):
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        return z if input_is_latent else mapping_apply(self.gen, z, self.ops)

    def _synthesize(self, w):
        return generator_forward(
            self.gen, w, input_is_latent=True, truncation=self.truncation,
            truncation_latent=self.mean_latent, ops=self.ops, dtype=self.dtype)

    def infer(self, z, input_is_latent=False):
        """The unfused form: (img (B,H,W,3), logits (B,H,W,C_out), z0's
        embedding or None)."""
        with torch.inference_mode():
            w = self._w(z, input_is_latent)
            return self._unfused(w)

    def infer_folded(self, z, input_is_latent=False):
        """``infer``'s outputs through the method's folded form."""
        with torch.inference_mode():
            w = self._w(z, input_is_latent)
            return self._folded(w)

    def serve(self, z, input_is_latent=False):
        """(img, labels, z0) for a batch of z (or w), the folded form."""
        return _argmax(*self.infer_folded(z, input_is_latent))

    def serve_unfused(self, z, input_is_latent=False):
        """``infer``'s (img, labels, z0): the oracle of ``serve``."""
        return _argmax(*self.infer(z, input_is_latent))


class ConcatServer(MethodServer):
    """RepurposeGAN: the head over the first ``n_layers`` feature maps'
    nearest-up concat; folded, ``embed.concat_segment_fcn``."""

    method = "repurposegan"

    def __init__(self, *args, n_layers, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_layers = n_layers

    def _unfused(self, w):
        img, feats = self._synthesize(w)
        x = pixel_feature_maps(feats, n_layers=self.n_layers)
        return img, one_shot_segmentor_apply(self.seg_params, x, self.seg_size), None

    def _folded(self, w):
        img, feats = self._synthesize(w)
        return img, concat_segment_fcn(feats, self.seg_params, self.seg_size,
                                       n_layers=self.n_layers), None


class PixelClassifierServer(MethodServer):
    """DatasetGAN: the eval-mode pixel classifier (BN ``state``) over the
    concat; folded, its first Linear projected level by level
    (``embed.project_feature_maps``), then ``pixel_classifier_from_first``."""

    method = "datasetgan"

    def __init__(self, *args, state, n_layers, **kwargs):
        super().__init__(*args, **kwargs)
        self.state = state
        self.n_layers = n_layers

    def _unfused(self, w):
        img, feats = self._synthesize(w)
        x = pixel_feature_maps(feats, n_layers=self.n_layers)
        logits, _ = pixel_classifier_apply(self.seg_params, self.state, x,
                                           train=False)
        return img, logits, None

    def _folded(self, w):
        img, feats = self._synthesize(w)
        first = self.seg_params[0]
        v1 = project_feature_maps(feats[: self.n_layers], first["weight"])
        v1 = v1 + first["bias"]
        return img, pixel_classifier_from_first(self.seg_params, self.state,
                                                v1), None


class SimCLRServer(MethodServer):
    """hfc_with_simclr: the projection (``params``, per-image BatchNorm
    statistics) then the head; folded, ``simclr.simclr_predict_segment``.
    z0 is sample 0's projection. The unfused form projects one image at a
    time (the JAX package vmaps it), so the batch never couples samples."""

    method = "hfc_with_simclr"

    def __init__(self, *args, params, hlen, interp="nearest", **kwargs):
        super().__init__(*args, **kwargs)
        self.params = params
        self.hlen = hlen
        self.interp = interp

    def _embed(self, feats):
        return simclr_predict_from_features(self.params, feats, self.hlen,
                                            self.interp)

    def _unfused(self, w):
        img, feats = self._synthesize(w)
        embs = [self._embed([f[i : i + 1] for f in feats])
                for i in range(w.shape[0])]
        logits = torch.cat([one_shot_segmentor_apply(self.seg_params, e,
                                                     self.seg_size)
                            for e in embs])
        return img, logits, embs[0]

    def _folded(self, w):
        img, feats = self._synthesize(w)
        logits = simclr_predict_segment(self.params, feats, self.seg_params,
                                        self.seg_size, self.hlen, self.interp)
        return img, logits, self._embed([f[:1] for f in feats])


class KMeansServer(MethodServer):
    """hfc_kmeans: the features of the preprocessor's own mean latent and
    truncation (``pre``, an ``HFCPreprocessor``; its latents truncated
    there, then again in the synthesis, as the JAX program does), each
    block's nearest center, the encoding and the head. The flat encoding's
    folded form is ``kmeans.hfc_segment_fcn`` over the blocks' channel
    parts; the belief encoding (``pre.hier_encode``, with the
    preprocessor's trained beliefs, or estimated from each request where
    it has none) re-takes the argmax between its products, so nothing
    folds and both forms are the unfused one, as in the JAX program. The
    image is a second synthesis at the model config's truncation."""

    method = "hfc_kmeans"

    def __init__(self, *args, pre, **kwargs):
        super().__init__(*args, **kwargs)
        pre.ensure_loaded()
        self.n_layers = pre.perturb_config["n_layers"]
        self.p_trunc = pre.perturb_config["truncation"]
        self.pre_mean = pre.mean_latent
        self.centers = pre.hfc_model.centers[: self.n_layers]
        self.cpl = list(pre.hfc_model.clusters_per_layer)
        self.out_size = pre.hfc_model.out_size
        self.hier_encode = pre.hier_encode
        self.beliefs = pre.trained_beliefs

    def _groups(self, w, concat):
        w = self.pre_mean + self.p_trunc * (w - self.pre_mean)
        w_plus = w[:, None, :].expand(-1, self.gen.meta["n_latent"], -1)
        _, feats = generator_forward(
            self.gen, [w_plus], input_is_latent=True, truncation=self.p_trunc,
            truncation_latent=self.pre_mean, ops=self.ops, dtype=self.dtype)
        groups = group_features_by_block(feats, skip_const=True, concat=concat)
        return groups[: self.n_layers]

    def _unfused(self, w, concat=True):
        x, _ = hfc_predict_from_features(self._groups(w, concat), self.centers,
                                         self.cpl, self.out_size,
                                         self.hier_encode, self.beliefs)
        logits = one_shot_segmentor_apply(self.seg_params, x, self.seg_size)
        return self._synthesize(w)[0], logits, None

    def _folded(self, w):
        if self.hier_encode:
            return self._unfused(w, concat=False)
        logits, _ = hfc_segment_fcn(self._groups(w, False), self.centers,
                                    self.cpl, self.out_size, self.seg_params,
                                    self.seg_size)
        return self._synthesize(w)[0], logits, None
