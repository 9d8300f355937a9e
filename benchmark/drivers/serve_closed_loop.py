"""Serving in a closed loop: ``clients`` = 1 caller sends a request of
``batch`` z, waits until the image, the labels and z0 are on the host, and
sends the next one, for the whole window (bulk generation of labelled
data: the caller wants the next batch as soon as the last is stored).

Traffic parameters (``benchmark/traffic/<mix>.json``):

- ``batch``: z a request;
- ``pool_requests``: distinct requests drawn from the seed at set-up, on
  the device in one draw; request i of the window takes pool entry
  i mod ``pool_requests``, so every seed sends the same sizes in the same
  number;
- ``warmup_requests``: requests served in set-up, before the window;
- ``check_requests``: requests of the window compared with the reference
  afterwards, a sample drawn from the seed (every request is equally
  likely);
- ``check_rows``: images the reference computes at a time;
- ``trace_seconds``: the window of a traced run, when shorter than
  ``--seconds`` (its trace is read whole).

The run's end-to-end quantities (``outcome.e2e``, read by the end-to-end
metrics' files): ``img_per_s``, the images of every request over the time
from the window's start to the end of its last request; ``p95_ms``, the
95th percentile of every request's latency (from the call into the server
until its outputs are on the host); ``setup_s``, from the start of the
process until the window opens.
"""

import gc
import math
import random
import statistics
import time
from types import SimpleNamespace

import torch

from harness import gaps, trace, weights
from harness.peaks import flops_peak


def _to_host(out):
    return tuple(None if t is None else t.cpu() for t in out)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b = tr["batch"]
    w = weights.make(ctx.reference.weight_shapes(cfg), cfg, ctx.seed, dev)
    server = ctx.system.build(cfg, w, ctx.seed, dev)

    def serve(z):
        return ctx.system.serve(server, z)

    if ctx.wrap is not None:
        serve = ctx.wrap(serve)
    n_pool = tr["pool_requests"]
    gen = torch.Generator(device=dev).manual_seed(weights.stream(ctx.seed, 1))
    pool = torch.randn(n_pool, b, cfg["style_dim"], generator=gen, device=dev)
    for i in range(tr["warmup_requests"]):
        _to_host(serve(pool[i % n_pool]))
    _sync(dev)

    seconds = ctx.seconds
    if ctx.trace:
        seconds = min(seconds, tr["trace_seconds"])
    pick = random.Random(ctx.seed)
    k = tr["check_requests"]
    samples = []  # (request index, host outputs): a reservoir of k
    records = []  # (call, return of the call, outputs on the host)
    prof = trace.profiler(dev) if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    gc.collect()
    gc.disable()  # the outputs are freed by their counts; no pauses inside
    setup_s = time.perf_counter() - ctx.t_start
    with torch.profiler.record_function(trace.WINDOW):
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while time.perf_counter() < deadline:
            z = pool[i % n_pool]
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.serve"):
                out = serve(z)
            t1 = time.perf_counter()
            with torch.profiler.record_function("bench.to_host"):
                host = _to_host(out)
            t2 = time.perf_counter()
            del out
            records.append((t0, t1, t2))
            if i < k:
                samples.append((i, host))
            else:
                j = pick.randrange(i + 1)
                if j < k:
                    samples[j] = (i, host)
            del host
            i += 1
        end = time.perf_counter()
    gc.enable()
    if prof is not None:
        prof.__exit__(None, None, None)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del server, serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    traced = trace.reduce(trace.export(prof)) if prof is not None else None
    del prof

    lat_ms = [(t2 - t0) * 1e3 for t0, _, t2 in records]
    e2e = {
        "setup_s": setup_s,
        "img_per_s": b * len(records) / (end - start),
        "p95_ms": (statistics.quantiles(lat_ms, n=100, method="inclusive")[94]
                   if len(lat_ms) > 1 else lat_ms[0]),
    }
    checks = compare(ctx, w, pool, samples)
    return SimpleNamespace(
        attempted=len(records), failed=0, e2e=e2e, checks=checks,
        memory_peak_bytes=peak, trace=traced, records=records, batch=b,
        window_s=end - start, config=cfg, flops=ctx.flops,
        peak_flops=flops_peak(cfg.get("inference_dtype")))


def compare(ctx, w, pool, samples):
    """The sampled requests against the reference, once the program is
    gone: {number: (value, limit)}."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ref = ctx.reference.Reference(cfg, w, dev)
    mean_w = ref.mean_latent(ctx.system.mean_latent_z(cfg, ctx.seed))
    got = {"image_gap": 0.0, "label_gap": 0.0, "z0_gap": 0.0}
    n_pool = pool.shape[0]
    with torch.no_grad():
        for i, (img, labels, z0) in samples:
            r_img, r_logits, r_emb0 = ref.request(pool[i % n_pool], mean_w,
                                                  rows=tr["check_rows"])
            got["image_gap"] = max(got["image_gap"], gaps.relative_gap(img, r_img))
            got["label_gap"] = max(got["label_gap"],
                                   gaps.argmax_gap(labels, r_logits))
            got["z0_gap"] = max(got["z0_gap"],
                                math.inf if z0 is None
                                else gaps.argmax_gap(z0, r_emb0[None]))
            del r_img, r_logits, r_emb0
    if not samples:
        got = {name: math.inf for name in got}
    return {name: (v, ctx.limits[name]) for name, v in got.items()}
