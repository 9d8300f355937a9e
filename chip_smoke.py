#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its serving and SwAV
pretraining paths on one GPU.

Run from the repository root on a machine with one CUDA card and nvcc
(found through CUDA_HOME, PATH or /usr/local/cuda):

    python3 chip_smoke.py [--details PATH]

Phases (any failure exits non-zero before the last line):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles ganecdotes_torch/csrc/*.cu for sm_90a, prints the time;
  3. kernels: each kernel at every shape the ffhq-256 serving path gives it
     at B = 8, held against its plain PyTorch version on the card (float32,
     TF32 off; the up conv also against conv_transpose + blur) and timed
     with CUDA events beside its plain version, one library call where one
     computes the same function, and its bound; the Sinkhorn kernel at the
     pretraining path's (patch_size, nprototypes) scores, uniform and image
     marginals, a ragged shape and niters = 0;
  4. serve: OneShotServer (ffhq-256, hfc_with_swav, random weights from a
     seed) answers 3 requests of 8 z with every kernel's launch counted;
     then a server with every op on its plain version on the card, its mean
     latent drawn anew from the same seed, answers the same requests;
  5. pretrain: SwAVClustering at the full hfc_with_swav ffhq config (random
     generator from a seed) takes 1 warm-up and 4 timed steps with every
     kernel's launch counted, saves and reloads swav_params.npz, and the same
     steps from the same seed run again with every op on its plain version;
     one more step runs under torch.profiler;
  6. one JSON line of the kernels, then the result line.

``--details PATH`` also writes every shape's numbers, the build record and
the serving and pretraining profiles to a JSON file.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8  # MAX_TEST_BATCH, one request
N_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
# kernel vs plain version: both float32, different summation order; the
# error stays within a few ulps of the largest partial sums
KERNEL_TOL = 1e-4  # max |kernel - plain| <= KERNEL_TOL * max(1, max |plain|)
IMAGE_TOL = 1e-3  # same measure for the served image after 13 conv layers
LABEL_AGREEMENT = 0.999
SINKHORN_TOL = 1e-4  # absolute, on codes in [0, 1]
PRETRAIN_STEPS = 4  # timed, after one warm-up step
# KERNELS vs PLAIN pretraining run, per-step loss and final params (see
# check_pretrain_agreement for the reason)
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_TOL = 1e-6  # max |kernels - plain| <= STEP_PARAM_TOL * max(1, max |plain|)

KERNELS_TABLE = {
    "fused_leaky_relu": ("ganecdotes_torch/csrc/fused_act.cu",
                         "ganecdotes_tpu/ops/fused_act.py:72"),
    "upfirdn2d": ("ganecdotes_torch/csrc/upfirdn2d.cu",
                  "ganecdotes_tpu/ops/upfirdn2d_pallas.py:132"),
    "styled_conv3x3": ("ganecdotes_torch/csrc/styled_conv.cu",
                       "ganecdotes_tpu/ops/modulated_conv_pallas.py:317"),
    "styled_up_conv3x3": ("ganecdotes_torch/csrc/styled_conv.cu",
                          "ganecdotes_tpu/ops/modulated_conv_pallas.py:564"),
    "sinkhorn_knopp": ("ganecdotes_torch/csrc/sinkhorn.cu",
                       "ganecdotes_tpu/ops/sinkhorn_pallas.py:380"),
}
SERVING_KERNELS = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
                   "styled_up_conv3x3")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, budget_ms=100.0):
    """Mean device time of ``fn`` over a run of launches, by CUDA events,
    after a warm-up; the run is sized to take about ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    iters = int(min(200, max(5, budget_ms / max(e0.elapsed_time(e1), 1e-3))))
    for _ in range(2):
        fn()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def errors(got, want):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, err / max(scale, 1e-30), scale


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the path's shapes
# ---------------------------------------------------------------------------


def path_shapes():
    """Per kernel, the (shape, calls per request) the ffhq-256 path gives."""
    from ganecdotes_torch.configs.models import ffhq_256 as mc
    from ganecdotes_torch.models.stylegan2.generator import channel_map

    size, n_mlp = mc.image_size, mc.gen_args["n_mlp"]
    ch = channel_map()
    res = [2**k for k in range(2, size.bit_length())]  # 4 .. size
    conv = [((B, r, r, ch[r], ch[r]), 1) for r in res]
    up = [((B, r // 2, r // 2, ch[r // 2], ch[r]), 1) for r in res[1:]]
    skip = [((B, r, r, 3), 1) for r in res[:-1]]
    lrelu = [((B, mc.latent_dim), n_mlp),
             ((mc.num_latents_for_mean, mc.latent_dim), 0)]  # setup only
    return {"fused_leaky_relu": lrelu, "upfirdn2d": skip,
            "styled_conv3x3": conv, "styled_up_conv3x3": up}


def styled_inputs(shape, up, gen, dev):
    b, h, w, ci, co = shape
    f = 2 if up else 1
    x = torch.randn(b, h, w, ci, generator=gen, device=dev)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    s = 1.0 + 0.3 * torch.randn(b, ci, generator=gen, device=dev)
    demod = torch.rsqrt(s.square() @ wt.square().sum((0, 1)) + 1e-8)
    noise = torch.randn(1, f * h, f * w, 1, generator=gen, device=dev)
    nw = torch.full((), 0.3, device=dev)
    bias = 0.1 * torch.randn(co, generator=gen, device=dev)
    return [x, wt, s, demod, noise, nw, bias]


def check_kernels(dev):
    import torch.nn.functional as F

    from ganecdotes_torch.ops import fused_act, modulated_conv, upfirdn2d

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, shapes in path_shapes().items():
        for shape, calls in shapes:
            lib = None  # one PyTorch call as a yardstick, where there is one
            other = None  # a second plain form, where the path has one
            if name == "fused_leaky_relu":
                x = torch.randn(*shape, generator=gen, device=dev)
                bias = torch.randn(shape[-1], generator=gen, device=dev)

                def kern(x=x, bias=bias):
                    return fused_act.fused_leaky_relu(x, bias)

                def plain(x=x, bias=bias):
                    return fused_act.fused_leaky_relu_ref(x, bias)

                moved = nbytes(x, bias, x)
                flops = 3 * x.numel()
            elif name == "upfirdn2d":
                x = torch.randn(*shape, generator=gen, device=dev)

                def kern(x=x):
                    return upfirdn2d.upsample_2d(x)

                def plain(x=x):
                    return upfirdn2d.upsample_2d(x, impl=upfirdn2d.upfirdn2d_ref)

                wk = torch.as_tensor(upfirdn2d.make_kernel((1, 3, 3, 1), gain=4.0),
                                     device=dev).expand(shape[3], 1, 4, 4)

                def lib(x=x, wk=wk):  # the same function in one call
                    return F.conv_transpose2d(
                        x.permute(0, 3, 1, 2), wk, stride=2, padding=1,
                        groups=x.shape[3]).permute(0, 2, 3, 1)

                out_n = x.numel() * 4
                moved = nbytes(x) + out_n * 4
                flops = 2 * out_n * 16 // 4  # 4 of the 16 taps see data
            else:
                up = name == "styled_up_conv3x3"
                args = styled_inputs(shape, up, gen, dev)
                fn = getattr(modulated_conv, name)
                ref = getattr(modulated_conv, name + "_ref")

                def kern(fn=fn, args=args):
                    return fn(*args)

                def plain(ref=ref, args=args):
                    return ref(*args)

                if up:  # conv_transpose + blur, independent of the phase taps
                    other = modulated_conv.styled_up_conv3x3_xla(*args)
                b, h, w, ci, co = shape
                f = 2 if up else 1
                moved = nbytes(*args) + b * f * h * f * w * co * 4
                # the least work for the function: the conv at its own
                # resolution (9 MACs per input pixel and channel pair); for
                # the up branch conv_transpose + 4x4 blur, which needs a
                # quarter of the MACs of the four composed phase filters
                flops = 2 * b * h * w * 9 * ci * co
                if up:
                    flops += 2 * b * (2 * h) * (2 * w) * co * 16
                xm = (args[0] * args[2][:, None, None, :]).permute(0, 3, 1, 2)
                if up:
                    wl = args[1].permute(2, 3, 0, 1).contiguous()

                    def lib(xm=xm, wl=wl):  # the conv part only
                        return F.conv_transpose2d(xm, wl, stride=2)
                else:
                    wl = args[1].permute(3, 2, 0, 1).contiguous()

                    def lib(xm=xm, wl=wl):  # the conv part only
                        return F.conv2d(xm, wl, padding=1)
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, rel, scale = errors(got, want)
            tol = KERNEL_TOL * max(1.0, scale)
            other_err = None if other is None else errors(got, other)[0]
            ok = err <= tol and (other_err is None or other_err <= tol)
            row = {
                "kernel": name, "shape": list(shape), "calls": calls,
                "max_abs_err": err, "max_rel_err": rel, "tol": tol,
                "max_abs_err_convT_blur": other_err, "ok": ok,
                "ms": time_ms(kern),
                "plain_ms": time_ms(plain),
                "library_ms": None, "library_err": None,
            }
            if lib is not None:
                if name == "upfirdn2d":
                    row["library_err"] = errors(lib(), want)[0]
                row["library_ms"] = time_ms(lib)
            row["bound_ms"], row["bound_by"] = bound_ms(moved, flops)
            row["bytes"], row["flops"] = moved, flops
            rows.append(row)
            print(f"  {name:18s} {str(tuple(shape)):26s} err {err:.3e} "
                  f"(rel {rel:.2e}, tol {tol:.1e}"
                  + ("" if other_err is None else f"; vs convT+blur {other_err:.3e}")
                  + ") "
                  f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
                  f"lib {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} "
                  f"bound {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
            check(ok, f"{name} {shape}: max abs err {err} (vs convT+blur "
                      f"{other_err}) over tolerance {tol}")
    return rows


def swav_configs():
    """(model config, perturb_args, swav_args, sinkhorn_args) of the
    hfc_with_swav ffhq-256 pretraining path, as shipped."""
    from ganecdotes_torch.configs.models import ffhq_256 as mc
    from ganecdotes_torch.configs.segmentors import hfc_with_swav_ffhq_config as sc

    prep = sc.hfc_prep_args
    return mc, prep["perturb_args"], prep["swav_args"], prep["sinkhorn_args"]


def sinkhorn_bound(b, k, niters):
    """(bytes, operations) the function needs: niters + 1 reads of the scores
    (one per iteration and one for the codes, the Gauss-Seidel least: each
    iteration needs the last one's potentials, and the scores do not fit in
    the 50 MB L2 at the path's shape) and one write of the codes; about 4
    operations (fma, compare, exp, add) per element per read."""
    n = b * k
    return (niters + 2) * n * 4 + 2 * (b + k) * 4, 4 * (niters + 1) * n


def check_sinkhorn(dev):
    """The Sinkhorn kernel against sinkhorn_knopp_ref at the pretraining
    path's scores: L2-normalised projections @ unit prototypes + bias."""
    from ganecdotes_torch.ops import sinkhorn
    from ganecdotes_torch.selfsup.swav import _histogram_pdf

    _, _, sa, sk = swav_configs()
    b, k, nc = sa["patch_size"], sa["nprototypes"], sa["nclasses"]
    niters, eps = sk["niters"], sk["eps"]
    calls = 2 * sa["num_patches"]  # per step
    gen = torch.Generator(device=dev).manual_seed(1)

    def scores(b, k):
        z = torch.nn.functional.normalize(
            torch.randn(b, nc, generator=gen, device=dev), dim=1)
        p = torch.nn.functional.normalize(
            torch.randn(nc, k, generator=gen, device=dev), dim=0)
        bias = (torch.rand(k, generator=gen, device=dev) * 2 - 1) / nc**0.5
        return (z @ p + bias).contiguous()

    def uniform(b, k):
        return (torch.ones(k, device=dev) / k, torch.ones(b, device=dev) / b)

    # an 'image' pdf: histograms of a 256 x 256 feature-norm-like map
    img = torch.randn(1, 256, 256, generator=gen, device=dev).abs() + 1.0
    cases = [
        ("uniform", b, k, niters, uniform(b, k), calls),
        ("image", b, k, niters, (_histogram_pdf(img, k), _histogram_pdf(img, b)), 0),
        ("ragged", b - 3, k - 1, niters, uniform(b - 3, k - 1), 0),
        ("niters0", b, k, 0, uniform(b, k), 0),
    ]
    rows = []
    for case, b_, k_, n_, (r, c), n_calls in cases:
        x = scores(b_, k_)

        def kern(x=x, n_=n_, r=r, c=c):
            return sinkhorn.sinkhorn_knopp(x, n_, eps, r, c)

        def plain(x=x, n_=n_, r=r, c=c):
            return sinkhorn.sinkhorn_knopp_ref(x, n_, eps, r, c)

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        moved, flops = sinkhorn_bound(b_, k_, n_)
        row = {
            "kernel": "sinkhorn_knopp", "case": case, "shape": [b_, k_],
            "niters": n_, "eps": eps, "calls": n_calls, "max_abs_err": err,
            "tol": SINKHORN_TOL, "max_abs_err_convT_blur": None,
            "ok": err <= SINKHORN_TOL and finite,
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": None,
            "bytes": moved, "flops": flops,
        }
        row["bound_ms"], row["bound_by"] = bound_ms(moved, flops)
        rows.append(row)
        print(f"  sinkhorn_knopp {case:8s} {str((b_, k_)):14s} niters {n_:2d} "
              f"err {err:.3e} (tol {SINKHORN_TOL:.0e}) ms {row['ms']:.4f} "
              f"plain {row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)
        check(row["ok"], f"sinkhorn {case} {(b_, k_)}: max abs err {err} "
                         f"(finite {finite}) over tolerance {SINKHORN_TOL}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def profile_request(server, z):
    """Device time by kernel for one request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(z)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0 and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:15]
    return {
        "wall_ms": wall,
        "device_busy_ms": busy if events else None,
        "top": [{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def serve(dev):
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import PLAIN
    from ganecdotes_torch.pipeline.serving import OneShotServer

    zs = [torch.randn(B, 512, generator=torch.Generator().manual_seed(100 + i))
          for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    server = OneShotServer(device=dev, seed=0)  # ffhq-256, hfc_with_swav
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    outs, times = [], []
    for z in zs:
        t0 = time.perf_counter()
        out = server.serve(z)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  setup {setup_s:.3f} s; request ms {[round(t, 3) for t in times]}; "
          f"launches {launches}; peak memory {peak / 2**30:.3f} GiB", flush=True)
    for k in SERVING_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the serving path")

    for img, labels, z0 in outs:
        check(tuple(img.shape) == (B, 256, 256, 3), f"image shape {tuple(img.shape)}")
        check(tuple(labels.shape) == (B, 256, 256), f"labels shape {tuple(labels.shape)}")
        check(tuple(z0.shape) == (1, 256, 256), f"z0 shape {tuple(z0.shape)}")
        check(bool(torch.isfinite(img).all()), "non-finite image")
        check(0 <= int(labels.min()) and int(labels.max()) < 12, "labels out of range")
        check(0 <= int(z0.min()) and int(z0.max()) < server.nclasses, "z0 out of range")

    prof = profile_request(server, zs[-1])

    # same seed, so the plain server draws the same 4096 z for its own mean
    # latent: the set-up's (4096, 512) fused_leaky_relu calls are checked too
    plain = OneShotServer(device=dev, seed=0, gen=server.gen,
                          ssl_params=server.ssl_params,
                          seg_params=server.seg_params, ops=PLAIN)
    mean_err, _, mean_scale = errors(server.mean_latent, plain.mean_latent)
    print(f"  mean latent vs plain: err {mean_err:.3e} "
          f"(tol {KERNEL_TOL * max(1.0, mean_scale):.1e})", flush=True)
    check(mean_err <= KERNEL_TOL * max(1.0, mean_scale),
          f"mean latent differs from the plain set-up: {mean_err}")
    img_err, lab_agree, z0_agree, plain_times = 0.0, 1.0, 1.0, []
    for z, (img, labels, z0) in zip(zs, outs):
        t0 = time.perf_counter()
        p_img, p_labels, p_z0 = plain.serve(z)
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - t0) * 1e3)
        err, _, scale = errors(img, p_img)
        img_err = max(img_err, err / max(1.0, scale))
        lab_agree = min(lab_agree, (labels == p_labels).float().mean().item())
        z0_agree = min(z0_agree, (z0 == p_z0).float().mean().item())
    print(f"  plain ops: request ms {[round(t, 3) for t in plain_times]}; "
          f"image err {img_err:.3e} (tol {IMAGE_TOL}); label agreement "
          f"{lab_agree:.6f}, z0 agreement {z0_agree:.6f} (>= {LABEL_AGREEMENT})",
          flush=True)
    check(img_err <= IMAGE_TOL, f"image differs from the plain run: {img_err}")
    check(lab_agree >= LABEL_AGREEMENT, f"label agreement {lab_agree}")
    check(z0_agree >= LABEL_AGREEMENT, f"z0 agreement {z0_agree}")
    steady = statistics.median(times[1:])
    return {
        "setup_s": setup_s, "request_ms": times, "steady_request_ms": steady,
        "img_per_s": B / steady * 1e3, "peak_memory_bytes": peak,
        "launches": launches, "plain_request_ms": plain_times,
        "mean_latent_err": mean_err, "image_err": img_err,
        "label_agreement": lab_agree,
        "z0_agreement": z0_agree, "profile": prof,
    }


# ---------------------------------------------------------------------------
# phase 5: SwAV pretraining
# ---------------------------------------------------------------------------

PROFILE_LABELS = ("swav.generator", "swav.projection", "swav.sinkhorn",
                  "swav.lars")


def profile_step(swav):
    """Device time of one KERNELS step (torch.profiler), split by the step's
    record_function ranges. Each range's device-side span is taken from the
    trace, and the device time of the kernels that start inside it is its
    share; kernels outside every range (the backward, which autograd runs on
    its own thread, and the loss) make up "loss/backward"."""
    from torch.profiler import ProfilerActivity, profile

    from ganecdotes_torch.selfsup.swav import draw_step_inputs, make_swav_train_step

    mc = swav._model_config_dict()
    optimizer, step = make_swav_train_step(
        swav.model.meta, mc, swav.perturb_args, swav.swav_args,
        swav.sinkhorn_args, swav.mean_latent, swav._image_hw, swav.ops)
    draws = draw_step_inputs(torch.Generator().manual_seed(7), swav.model.meta,
                             mc, swav.perturb_args, swav.swav_args, swav._image_hw)
    opt_state = optimizer.init(swav.ssl_params)
    step(swav.model, swav.ssl_params, opt_state, draws, 0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(swav.model, swav.ssl_params, opt_state, draws, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in device
             if e.name in PROFILE_LABELS]
    kernels = [e for e in device if e.name not in PROFILE_LABELS]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    split = {label: 0.0 for label in PROFILE_LABELS}
    span_ms = {label: 0.0 for label in PROFILE_LABELS}
    for label, t0_us, t1_us in spans:
        span_ms[label] += (t1_us - t0_us) / 1e3
    for e in kernels:
        label = next((lb for lb, a, b in spans if a <= e.time_range.start < b), None)
        if label is not None:
            split[label] += e.time_range.elapsed_us() / 1e3
    split["loss/backward"] = busy - sum(split.values())
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
        "split_ms": split, "span_ms": span_ms,
        "top": [{"name": k[:90], "ms": ms, "count": n} for k, (n, ms) in top],
    }


def run_pretrain(gen, dev, ops, out_dir=None):
    """SwAVClustering(...).pretrain() at the shipped config for 1 + PRETRAIN_STEPS
    steps; the swav and the per-step host-clock ms."""
    from ganecdotes_torch.selfsup.swav import SwAVClustering

    mc, pa, sa, sk = swav_configs()
    sa = dict(sa, num_epochs=1 + PRETRAIN_STEPS, num_samples=1)
    swav = SwAVClustering(gen, mc, pa, sa, sk, out_dir=out_dir, device=dev,
                          seed=42, ops=ops)
    swav.record_loss_history = True
    swav.pretrain()
    torch.cuda.synchronize()
    ends = [0.0] + swav.epoch_seconds
    return swav, [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]


def pretrain(dev):
    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import KERNELS, PLAIN
    from ganecdotes_torch.selfsup.lars import tree_leaves
    from ganecdotes_torch.selfsup.swav import SwAVClustering

    mc, pa, sa, sk = swav_configs()
    gen = Generator(**mc.gen_args, generator=torch.Generator().manual_seed(0)).to(dev)
    out_dir = os.path.join(ROOT, "build", "chip_smoke_swav")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    swav, step_ms = run_pretrain(gen, dev, KERNELS, out_dir)
    total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + PRETRAIN_STEPS
    timed = step_ms[1:]
    steady = statistics.median(timed)
    print(f"  {steps} steps in {total_s:.3f} s (set-up included); step ms "
          f"{[round(t, 3) for t in step_ms]} (first: warm-up); median "
          f"{steady:.3f} ms, {1e3 / steady:.3f} steps/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)
    for k in KERNELS_TABLE:
        check(launches[k] > 0, f"kernel {k} was not launched on the pretraining path")
    per_step = 2 * sa["num_patches"]
    check(launches["sinkhorn_knopp"] == per_step * steps,
          f"sinkhorn launched {launches['sinkhorn_knopp']} times in {steps} "
          f"steps, expected {per_step} per step")
    losses = swav.loss_history
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"losses {losses}")
    params = swav.ssl_params
    check(tuple(params["projection"][0]["weight"].shape) == (sa["hlen"], sa["nclasses"])
          and tuple(params["prototype"]["weight"].shape) == (sa["nclasses"], sa["nprototypes"]),
          "param shapes")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          "non-finite params")

    # swav_params.npz, saved by pretrain, loads back exactly
    loaded = SwAVClustering(gen, mc, pa, sa, sk, train=False, out_dir=out_dir,
                            device=dev, seed=42)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                tree_leaves(loaded.ssl_params))),
          "swav_params.npz did not load back equal")
    preds, labels = loaded.predict_swav_codes(
        torch.randn(1, 512, generator=torch.Generator().manual_seed(3)),
        input_is_latent=False)
    check(tuple(preds.shape) == (1, mc.image_size, mc.image_size, sa["nclasses"])
          and bool(torch.isfinite(preds).all()), "predict_swav_codes output")

    prof = profile_step(swav)
    print(f"  one step under torch.profiler: {json.dumps(prof)}", flush=True)

    plain, plain_ms = run_pretrain(gen, dev, PLAIN)
    agreement = check_pretrain_agreement(swav, plain)
    print(f"  plain ops: step ms {[round(t, 3) for t in plain_ms]}; "
          f"{json.dumps(agreement)}", flush=True)
    return {
        "steps": steps, "step_ms": step_ms, "steady_step_ms": steady,
        "steps_per_s": 1e3 / steady, "total_s": total_s,
        "peak_memory_bytes": peak, "launches": launches, "losses": losses,
        "plain_step_ms": plain_ms, "plain_losses": plain.loss_history,
        "agreement": agreement, "profile": prof,
    }


def check_pretrain_agreement(kern, plain):
    """The KERNELS run against the PLAIN run from the same seed (same
    draws, same init): per-step loss within STEP_LOSS_RTOL, final params
    within STEP_PARAM_TOL * max(1, max |plain|).

    Both runs are float32 with TF32 off and differ only in the kernels'
    summation order, so they agree to float32 rounding: on an NVIDIA H100
    80GB HBM3 at 700 W the five steps' losses differed by at most 1.5e-7
    relative and the params by 2.2e-8. The tolerances leave some 50x margin over that; a kernel that
    computes something else moves a loss of ~10 by far more than 1e-4.
    """
    from ganecdotes_torch.selfsup.lars import tree_leaves

    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(kern.loss_history, plain.loss_history))
    param_err = 0.0
    for a, b in zip(tree_leaves(kern.ssl_params), tree_leaves(plain.ssl_params)):
        err, _, scale = errors(a, b)
        param_err = max(param_err, err / max(1.0, scale))
    out = {"losses": kern.loss_history, "plain_losses": plain.loss_history,
           "loss_max_rel_err": loss_rel, "param_max_err": param_err}
    check(loss_rel <= STEP_LOSS_RTOL,
          f"losses differ from the plain run: {loss_rel} > {STEP_LOSS_RTOL}")
    check(param_err <= STEP_PARAM_TOL,
          f"params differ from the plain run: {param_err} > {STEP_PARAM_TOL}")
    return out


def kernels_line(rows, launches):
    out = []
    for name, (source, replaces) in KERNELS_TABLE.items():
        rs = [r for r in rows if r["kernel"] == name]
        per_req = [r for r in rs if r["calls"] > 0]

        def total(key, per_req=per_req):
            vals = [r[key] for r in per_req]
            if any(v is None for v in vals):
                return None
            return sum(v * r["calls"] for v, r in zip(vals, per_req))

        t_b = sum(r["bytes"] * r["calls"] for r in per_req) / HBM_BYTES_PER_S * 1e3
        t_f = sum(r["flops"] * r["calls"] for r in per_req) / FP32_FLOPS * 1e3
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(max(r["max_abs_err"], r["max_abs_err_convT_blur"] or 0.0)
                               for r in rs),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "library_ms": total("library_ms"),
        })
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--details", help="write per-shape details to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    print("build:", flush=True)
    _build.load()
    info = _build.BUILD_INFO
    print(f"  {info['seconds']:.2f} s (compiled: {info['compiled']}) -> "
          f"{os.path.relpath(info['library'], ROOT)}", flush=True)
    with open(info["log"]) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    print("kernels vs plain versions (ms per call, CUDA events):", flush=True)
    rows = check_kernels(dev) + check_sinkhorn(dev)
    print("serve (ffhq-256, hfc_with_swav, B = 8):", flush=True)
    served = serve(dev)
    print(f"  steady request {served['steady_request_ms']:.3f} ms, "
          f"{served['img_per_s']:.2f} img/s; profile: {json.dumps(served['profile'])}",
          flush=True)
    print("pretrain (ffhq-256, hfc_with_swav SwAV, full config):", flush=True)
    pretrained = pretrain(dev)

    # each kernel's launches from the path it belongs to; the serving
    # kernel rows are per request of 8, the Sinkhorn row per SwAV step
    launches = dict(served["launches"],
                    sinkhorn_knopp=pretrained["launches"]["sinkhorn_knopp"])
    line = kernels_line(rows, launches)
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"card": smi, "kind": kind, "build": info, "shapes": rows,
                       "serve": served, "pretrain": pretrained, "kernels": line},
                      f, indent=1)
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report any phase's failure, exit non-zero, no result
        traceback.print_exc()
        sys.exit(1)
