"""Batched generate -> embed -> segment serving for hfc_with_swav (port of
the hfc_with_swav branch of ganecdotes_tpu OneShotPipeline._make_infer_fn,
pipeline/one_shot_pipeline.py:563-631, and the request loop of run_tests,
:933-950).

A request is a batch of z (B, latent_dim), or of w with
``input_is_latent=True`` (the pipeline's test latents). The server maps z
to w, runs the StyleGAN2 synthesis with truncation toward the mean latent
and the fixed noise buffers, and returns ``(img, labels, z0)`` as the JAX
``infer`` does: ``labels`` (B, H, W) is the argmax of the head's logits,
``z0`` (1, H, W) the argmax of the first sample's projection (its cluster
map).

``serve`` computes the logits as the JAX program does, with the head's
first conv folded into the feature pyramid (``infer_folded``,
``embed.project_segment_fcn``): the (B, H, W, nclasses) embedding is
computed for sample 0 only, for ``z0``. ``infer`` keeps the unfused form,
projection then head, as the oracle the folded form is held against
(``serve_unfused`` is its argmax).
"""

import torch

from ganecdotes_torch import resolve_device
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import (
    Generator,
    generator_forward,
    mapping_apply,
    mean_latent as _mean_latent,
)
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.selfsup.embed import project_segment_fcn
from ganecdotes_torch.selfsup.heads import (
    DILATIONS,
    init_one_shot_segmentor,
    one_shot_segmentor_apply,
)
from ganecdotes_torch.selfsup.swav import init_swav_params, swav_predict_from_features


class OneShotServer:
    """hfc_with_swav serving on one device.

    Weights are random from ``seed`` (one ``torch.Generator`` each for the
    generator, the mean latent, the SwAV params and the head), as the JAX
    pipeline does with ``model_path=None``, unless carried in: ``gen`` (a port
    ``Generator``), ``ssl_params``, ``seg_params`` and ``mean_latent``.

    ``device=None`` runs on ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain path. ``ops`` is ``KERNELS`` (the CUDA
    kernels) or ``PLAIN`` (their plain PyTorch versions, the reference the
    kernels are checked against on the card).
    """

    def __init__(self, model_config=None, seg_config=None, *, device=None,
                 seed=0, gen=None, ssl_params=None, seg_params=None,
                 mean_latent=None, ops=KERNELS):
        if model_config is None:
            from ganecdotes_torch.configs.models import ffhq_256 as model_config
        if seg_config is None:
            from ganecdotes_torch.configs.segmentors import (
                hfc_with_swav_ffhq_config as seg_config,
            )
        self.device = resolve_device(device)
        self.ops = ops
        mc, sc = model_config, seg_config
        sa = sc.hfc_prep_args["swav_args"]
        self.hlen = sa["hlen"]
        self.nclasses = sa["nclasses"]
        self.projn_nw = sa["projn_nw"]
        self.interp = sa.get("hf_interp", "nearest")
        self.seg_size = dict(sc.seg_args).get("size", "S")
        if (self.projn_nw != "linear" or self.interp != "nearest"
                or self.seg_size not in DILATIONS):
            raise NotImplementedError(
                "serving is ported for the linear projection, nearest "
                "interpolation and the FCN heads; got "
                f"{self.projn_nw!r}, {self.interp!r}, {self.seg_size!r}")
        self.truncation = mc.truncation

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

    def _synthesize(self, z, input_is_latent):
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        w = z if input_is_latent else mapping_apply(self.gen, z, self.ops)
        return generator_forward(
            self.gen, w, input_is_latent=True, truncation=self.truncation,
            truncation_latent=self.mean_latent, ops=self.ops)

    def _project(self, feats):
        return swav_predict_from_features(
            self.ssl_params, feats, self.hlen, self.nclasses, self.projn_nw,
            self.interp)

    def infer(self, z, input_is_latent=False):
        """The unfused form: (img (B,H,W,3), logits (B,H,W,C_out), the
        embedding of sample 0 (1,H,W,nclasses)) for a batch of z (or w)."""
        with torch.inference_mode():
            img, feats = self._synthesize(z, input_is_latent)
            emb = self._project(feats)
            logits = one_shot_segmentor_apply(self.seg_params, emb,
                                              self.seg_size)
            return img, logits, emb[:1]

    def serve_unfused(self, z, input_is_latent=False):
        """``infer``'s (img, labels, z0)."""
        img, logits, emb0 = self.infer(z, input_is_latent)
        return img, logits.argmax(dim=-1), emb0.argmax(dim=-1)

    def infer_folded(self, z, input_is_latent=False):
        """``infer``'s outputs with the head's first conv folded into the
        pyramid: only sample 0's embedding is computed."""
        with torch.inference_mode():
            img, feats = self._synthesize(z, input_is_latent)
            logits = project_segment_fcn(
                feats, self.ssl_params["projection"][0]["weight"],
                self.seg_params, self.seg_size, hlen=self.hlen)
            return img, logits, self._project([f[:1] for f in feats])

    def serve(self, z, input_is_latent=False):
        """(img, labels, z0) for a batch of z (or w), as the JAX ``infer``
        computes them: ``infer_folded``'s argmaxes."""
        img, logits, emb0 = self.infer_folded(z, input_is_latent)
        return img, logits.argmax(dim=-1), emb0.argmax(dim=-1)
