"""Training as the BagGAN CLI runs it: each iteration takes the native
loader's next batch, calls ``set_input`` and ``optimize_parameters``, then
waits for the card, for the whole window. No checkpoint is written.

Set-up writes the configuration's data set (``files`` uint8 .npy images
drawn from the seed) into a temporary folder, builds the trainer at the
benchmark's initial state and runs the first ``checked_iterations``
iterations through the same loop body: iteration 0 runs every step kind (D,
R1, G, PPL), so every shape of the window is warm. Those iterations are the
ones held against the reference afterwards, and for them the benchmark
draws every random number (latents, the mixing coin and its inject index,
noise maps, ADA's matrices at the configuration's p, the penalty's alpha,
the PPL probes) from the seed (``make_draws``) and hands the same to the
program and the reference. Every later iteration draws from the trainer's
own generator, seeded with the run's seed, as the CLI does: set-up runs
``warmup_iterations`` of those, so the trainer's draw path is warm too,
and the window starts at the next iteration.

Traffic parameters (``benchmark/traffic/<mix>.json``): ``files``,
``checked_iterations``, ``warmup_iterations``, ``trace_iterations`` (a
traced run's window: that many whole iterations, one period of the lazy
R1, or ``--seconds``, whichever ends first).

The run's end-to-end quantities (``outcome.e2e``): ``img_per_s``, the
batch times the iterations completed in the window over the time from its
start to the end of the last one; ``setup_s``.
"""

import gc
import math
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import ada_draws, gaps, trace, weights
from harness.peaks import flops_peak


def make_draws(cfg, it, seed, device):
    """The draws of iteration ``it`` (a dict of the trainer's draw fields)."""
    b, s, style = cfg["batch_size"], cfg["size"], cfg["style_dim"]
    n_latent = 2 * int(math.log2(s)) - 2
    gen = torch.Generator(device=device).manual_seed(weights.stream(seed, 1000 + it))
    coin = random.Random(weights.stream(seed, 1000 + it))

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def noise():
        return [normal(b, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1)
                for i in range(n_latent - 1)]

    def aug():
        return ada_draws.draw(gen, cfg["augment_p"], b, s, s, device)

    z = normal(2, b, style)
    if coin.random() < cfg["mixing_prob"]:
        zs, inject = [z[0], z[1]], coin.randint(1, n_latent - 1)
    else:
        zs, inject = [z[0]], n_latent
    d = {"z": zs, "inject_index": inject, "d_noise": noise(),
         "d_fake_aug": aug(), "d_real_aug": aug(),
         "gp_alpha": torch.rand(b, 1, 1, 1, generator=gen, device=device),
         "r1_aug": aug() if it % cfg["d_reg_every"] == 0 else None}
    d["g_noise"] = noise()
    d["g_aug"] = aug()
    d["ppl_z"] = d["ppl_noise_imgs"] = None
    if it % cfg["g_reg_every"] == 0:
        pb = max(1, b // cfg["path_batch_shrink"])
        d["ppl_z"] = normal(pb, style)
        d["ppl_noise_imgs"] = normal(pb, s, s, cfg["num_channels"]) / float(s)
    return d


def write_data(cfg, n, seed, folder):
    """``n`` uint8 (H, W, C) images from the seed, one .npy file each."""
    s = cfg["size"]
    gen = torch.Generator().manual_seed(weights.stream(seed, 2))
    imgs = torch.randint(0, 256, (n, s, s, cfg["num_channels"]), dtype=torch.uint8,
                         generator=gen).numpy()
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(folder, f"{i:05d}.npy"))
        np.save(paths[-1], img)
    return imgs, paths


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx):
    cfg, tr, dev, system = ctx.config, ctx.traffic, ctx.device, ctx.system
    folder = tempfile.mkdtemp(prefix="bench_train_")
    try:
        imgs, paths = write_data(cfg, tr["files"], ctx.seed, folder)
        w = weights.make(ctx.reference.weight_shapes(cfg), cfg, ctx.seed, dev)
        gan = system.build(cfg, w, ctx.seed, dev, folder)
        loader = system.loader(cfg, paths)
        try:
            step = system.step if ctx.wrap is None else ctx.wrap(system.step)
            first = system.watch_first_grads(gan)
            first_image = system.watch_first_image(gan)
            checked = []
            for it in range(tr["checked_iterations"]):
                batch = loader.next()
                d = make_draws(cfg, it, ctx.seed, dev)
                step(gan, batch, it, d)
                _sync(dev)
                checked.append((it, batch, d, system.losses(gan, it, cfg)))
                system.unwatch(gan)
            after = {k: v.detach().clone() for k, v in system.params(gan).items()}
            it0 = tr["checked_iterations"]
            for it in range(it0, it0 + tr["warmup_iterations"]):
                step(gan, loader.next(), it)
                _sync(dev)
            outcome = window(ctx, gan, loader, step, it0 + tr["warmup_iterations"])
        finally:
            loader.close()
        outcome.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)
        del gan, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prof = outcome.prof
        outcome.trace = trace.reduce(trace.export(prof)) if prof is not None else None
        del outcome.prof, prof
        outcome.checks = compare(ctx, w, imgs, checked, first, first_image, after)
        return outcome
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def window(ctx, gan, loader, step, it0):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b = cfg["batch_size"]
    last = it0 + tr["trace_iterations"] if ctx.trace else math.inf
    records = []  # (iteration, start, batch in hand, end)
    prof = trace.profiler(dev) if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    gc.collect()
    setup_s = time.perf_counter() - ctx.t_start
    with torch.profiler.record_function(trace.WINDOW):
        start = time.perf_counter()
        deadline = start + ctx.seconds
        it = it0
        while it < last and time.perf_counter() < deadline:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.next"):
                batch = loader.next()
            t1 = time.perf_counter()
            with torch.profiler.record_function("bench.iteration"):
                step(gan, batch, it)
            with torch.profiler.record_function("bench.sync"):
                _sync(dev)
            t2 = time.perf_counter()
            records.append((it, t0, t1, t2))
            it += 1
        end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    return SimpleNamespace(
        attempted=len(records), failed=0, records=records, batch=b,
        window_s=end - start, config=cfg, flops=ctx.flops, prof=prof,
        peak_flops=flops_peak(cfg.get("compute_dtype")),
        e2e={"setup_s": setup_s,
             "img_per_s": b * len(records) / (end - start)})


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in tree.items()}


def leaf_gaps(got, ref, leaves):
    """Each leaf's gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    got, ref = _norms({k: got[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    floor = statistics.median(ref.values())
    return [abs(got[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in leaves]


def worst_leaf(got, ref, leaves):
    """The largest of ``leaf_gaps``."""
    return max(leaf_gaps(got, ref, leaves))


def compare(ctx, w, imgs, checked, first, first_image, after):
    """The checked iterations against the reference: {number: (value,
    limit)}. The numbers: ``batch_mismatch``, the delivered images that
    are no file of the data set; ``image_gap``, the first image the program
    synthesised (iteration 0's D step, from the initial weights: the
    synthesis at the cell's type), as ``gaps.relative_gap`` (a missing
    image, or one of another shape, reads inf); ``loss_d0``, the first D
    loss (from the initial weights: rounding alone); ``loss_gap``, every
    later loss of the checked iterations; ``grad_<kind>``, each step kind's
    gradient of iteration 0 by the worst leaf, and ``grad_<kind>_median``
    by the median leaf (a reading steadier against the noise that earlier
    steps leave in a few leaves); ``change_gap``, the parameters' change
    over the checked iterations by the worst leaf. A loss gap is over the
    reference's loss or 1, whichever is larger. Only the numbers the
    cell's limits name are compared."""
    cfg, dev = ctx.config, ctx.device
    lookup = {img.tobytes(): i for i, img in enumerate(imgs)}
    ref = ctx.reference.Trainer(cfg, w, dev)
    got = {"batch_mismatch": 0.0, "image_gap": math.inf, "loss_d0": 0.0,
           "loss_gap": 0.0}
    for it, batch, d, losses in checked:
        u8 = np.clip(np.rint((batch + 1.0) * 127.5), 0, 255).astype(np.uint8)
        idx = [lookup.get(img.tobytes()) for img in u8]
        bad = sum(i is None or not np.array_equal(
            imgs[i].astype(np.float32) / np.float32(127.5) - np.float32(1.0), x)
            for i, x in zip(idx, batch))
        if bad:
            return {"batch_mismatch": (float(bad), ctx.limits["batch_mismatch"]),
                    **{k: (math.inf, lim) for k, lim in ctx.limits.items()
                       if k != "batch_mismatch"}}
        real = torch.from_numpy(imgs[idx]).to(dev).float() / 127.5 - 1.0
        for kind, v in ref.iteration(it, real, d).items():
            gap = abs(losses.get(kind, math.nan) - v) / max(abs(v), 1.0)
            gap = gap if math.isfinite(gap) else math.inf
            key = "loss_d0" if (it, kind) == (0, "d") else "loss_gap"
            got[key] = max(got[key], gap)
    if "image" in first_image:
        got["image_gap"] = gaps.relative_gap(first_image["image"],
                                             ref.first_image["image"])
    for kind, grads in ref.first_grads.items():
        by_leaf = (leaf_gaps(first[kind], grads, list(grads)) if kind in first
                   else [math.inf])
        got[f"grad_{kind}"] = max(by_leaf)
        got[f"grad_{kind}_median"] = statistics.median(by_leaf)
    # leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move by round-off alone
    g = {}
    for grads in ref.first_grads.values():
        for k, n in _norms(grads).items():
            g[k] = max(g.get(k, 0.0), n)
    floor = 1e-3 * statistics.median(g.values())
    leaves = [k for k, n in g.items() if n >= floor]
    now = ref.params()
    got["change_gap"] = worst_leaf(
        {k: after[k] - w[k] for k in leaves},
        {k: now[k].detach() - w[k] for k in leaves}, leaves)
    # a number the cell's limits leave out has no reading that separates a
    # fault from a sound run (PERF.md): printed, not compared
    for k, v in got.items():
        if k not in ctx.limits:
            print(f"reading {k} {v} (not compared)", file=sys.stderr)
    return {k: (v, ctx.limits[k]) for k, v in got.items() if k in ctx.limits}
