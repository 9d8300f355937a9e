"""How far float32 rounding alone moves each method's one-shot fine-tune at
ffhq-256, beside how far the CUDA kernels move it (``chip_smoke.py``
phase 9).

The kernels sum in other orders than their plain PyTorch versions, so the
one-shot features of a kernels run and of a plain run differ by float32
rounding, and 200 epochs of Adam can carry that difference further. This
script runs every op on its plain version (no kernel at all), fits or
pretrains what the method needs (SimCLR's 5 steps, the k-means fit),
takes the one-shot features, and fine-tunes the head from one init:

- ``base``: on the features as computed;
- ``repeat``: ``base`` again (the fine-tune repeats bit for bit);
- ``ulp<s>``: on the features with every entry moved by one rounding step
  (``torch.nextafter`` toward +-inf, signs from seed s), three seeds;
- ``other_conv`` (the FCN heads): on the base features, with the head's
  first conv by the other form (cuDNN for the matmul form or the reverse),
  which rounds otherwise;
- ``kernels``: on the one-shot features computed with the CUDA kernels
  (the synthesis, and the preprocessor's), as a kernels run computes them;

and reports for each variant the features' distance from ``base``'s
(max |a - b| / max(1, max |b|)), the loss after the first chunk and after
the last, relative to ``base``, and the share of the test labels (16
samples, 2 requests, served by the plain ops) equal to ``base``'s. For
hfc_kmeans it also fits the clusterers on the fit's block features as
computed (``base``, fresh k-means++ picks), moved by one rounding step
(three seeds) and computed with the kernels, each from ``base``'s picks,
and reports the fitted centers' distance from ``base``'s.

    python3 method_rounding.py [--methods repurposegan,datasetgan,...]
                               [--out FILE] [--device cuda]
"""

import argparse
import json
import logging
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ganecdotes_torch import resolve_device  # noqa: E402
from ganecdotes_torch.configs.models import ffhq_256  # noqa: E402
from ganecdotes_torch.models.stylegan2.generator import Generator  # noqa: E402
from ganecdotes_torch.ops.opset import KERNELS, PLAIN  # noqa: E402
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline  # noqa: E402
from ganecdotes_torch.selfsup.heads import (  # noqa: E402
    init_one_shot_segmentor,
    init_pixel_classifier,
)

METHODS = ("repurposegan", "datasetgan", "hfc_with_simclr", "hfc_kmeans")
TEST_SAMPLES = 16
ULP_SEEDS = (1, 2, 3)


def one_rounding_step(x, seed):
    """Every entry of ``x`` moved to its float32 neighbour, up or down by a
    seeded coin."""
    up = torch.rand(x.shape, generator=torch.Generator().manual_seed(seed)) < 0.5
    inf = torch.where(up, float("inf"), float("-inf")).to(x.device)
    return torch.nextafter(x, inf)


def rel_err(a, b):
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def kernels_features(pipe):
    """The one-shot features as a kernels run computes them."""
    pre = pipe.preprocessor
    pipe.ops = KERNELS
    if pre is not None:
        pre.ops = KERNELS
    try:
        pipe.one_shot_features = pipe.get_image_from_latent(
            pipe.one_shot_latent[None], return_features=True)[1]
        return OneShotPipeline._extract_one_shot_features(pipe).detach()
    finally:
        pipe.ops = PLAIN
        if pre is not None:
            pre.ops = PLAIN


def fit_spread(pipe):
    """The k-means centers fitted on the block features as computed, moved
    by one rounding step and computed with the kernels, from one set of
    k-means++ picks."""
    pre, model = pipe.preprocessor, pipe.preprocessor.hfc_model
    pc = pre.perturb_config
    n = pc["n_samples"] * pipe.model.meta["n_latent"]
    z_rands = [torch.randn(n, pipe.model_config.latent_dim,
                           generator=torch.Generator().manual_seed(10 + k))
               for k in range(pc["n_layers"])]
    hidden = pre.block_features(pipe.one_shot_latent, z_rands)
    pre.ops = KERNELS
    hidden_k = pre.block_features(pipe.one_shot_latent, z_rands)
    pre.ops = PLAIN
    model.replay_seeds = None
    model.fit(hidden)
    base = [c.clone() for c in model.centers]
    model.replay_seeds = list(model.seed_indices)
    variants = [(f"ulp{s}", [one_rounding_step(h, s) for h in hidden])
                for s in ULP_SEEDS] + [("kernels", hidden_k)]
    out = {"kernels_feature_err": max(rel_err(a, b) for a, b in zip(hidden_k, hidden))}
    for name, h in variants:
        model.fit(h)
        out[name] = max(rel_err(a, b) for a, b in zip(model.centers, base))
        print(f"  {pipe.seg_str} fit {name}: center err {out[name]:.3e}", flush=True)
    return out


def probe(method, gen, dev, out_dir, model="ffhq-256"):
    pipe = OneShotPipeline(out_dir, model=model, segmentor=method,
                           num_test_samples=TEST_SAMPLES, device=dev, ops=PLAIN,
                           gen=gen)
    pipe.logger.setLevel(logging.WARNING)
    sc = pipe.seg_config
    if hasattr(sc, "hfc_prep_args"):
        sc.train_hfc = True
        sc.hfc_prep_args["train"] = True
        if method == "hfc_with_simclr":
            sc.hfc_prep_args["simclr_args"]["num_iters"] = 5
    pipe.setup()
    feats = pipe._extract_one_shot_features().detach()
    sc.train_hfc = False  # the fits above are done; the variants reuse them

    n_class = len(pipe.model_config.classes)
    size = sc.seg_args.get("size", "S")
    g = torch.Generator().manual_seed(1)
    if method == "datasetgan":
        init, state = init_pixel_classifier(feats.shape[-1], n_class, generator=g)
    else:
        init, state = init_one_shot_segmentor(feats.shape[-1], n_class, size,
                                              generator=g), None
    variants = [("base", feats, None), ("repeat", feats, None)]
    variants += [(f"ulp{s}", one_rounding_step(feats, s), None) for s in ULP_SEEDS]
    if method != "datasetgan":
        variants.append(("other_conv", feats, "swap"))
    variants.append(("kernels", kernels_features(pipe), None))

    w = torch.as_tensor(pipe.test_latents[:TEST_SAMPLES])
    out, base = {}, None
    for name, f, conv in variants:
        pipe._extract_one_shot_features = lambda f=f: f
        pipe.segmentor_init_params, pipe.segmentor_init_state = init, state
        if conv == "swap":
            pipe.finetune_conv = {"matmul": "cudnn", "cudnn": "matmul"}[base["conv"]]
        t0 = time.perf_counter()
        pipe.run_trainer()
        losses = [loss for _, loss, _ in pipe.finetune_log]
        infer = pipe._make_infer_fn()
        labels = torch.cat([infer(w[i : i + 8])[1] for i in range(0, TEST_SAMPLES, 8)])
        rec = {"conv": pipe.finetune_conv, "first_loss": losses[0],
               "last_loss": losses[-1], "seconds": time.perf_counter() - t0}
        if base is None:
            base, base_labels = rec, labels
        else:
            rec["feature_err"] = rel_err(f, feats)
            rec["first_loss_rel"] = abs(losses[0] - base["first_loss"]) / abs(base["first_loss"])
            rec["last_loss_rel"] = abs(losses[-1] - base["last_loss"]) / abs(base["last_loss"])
            rec["label_agreement"] = (labels == base_labels).float().mean().item()
        out[name] = rec
        pipe.finetune_conv = base["conv"]
        print(f"  {method} {name}: {json.dumps(rec)}", flush=True)
    if method == "hfc_kmeans":
        out["fit"] = fit_spread(pipe)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--methods", default=",".join(METHODS))
    parser.add_argument("--out", help="write the results to this JSON file")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = Generator(**ffhq_256.gen_args,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    root = os.path.join(ROOT, "build", "method_rounding")
    shutil.rmtree(root, ignore_errors=True)
    results = {m: probe(m, gen, dev, os.path.join(root, m))
               for m in args.methods.split(",")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
