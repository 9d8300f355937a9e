#!/usr/bin/env python3
"""Time the port's StyledConv, Sinkhorn, FIR, fused act and ADA resample
kernels of two checkouts in turns on one GPU, so that a change is compared
with its parent on the same card.

    python3 kernel_ab.py BASE_DIR NEW_DIR [--rounds N] [--out PATH]

Each turn is a fresh process that imports ``ganecdotes_torch`` and the
helpers of ``chip_smoke.py`` from one checkout (building that checkout's
kernels under its own ``build/``) and times, with CUDA events, at the shapes
of the ffhq-256 serving request (B = 8), the SwAV step and the BagGAN-HQ
iteration:

  * styled_conv3x3 and styled_up_conv3x3, ms per request (each layer's time
    summed over the request's calls), and per layer; the same two in
    float32 at the pidray G step's rosinality widths at B = 20, one noise
    map per sample (``styled_conv3x3_g20``, ``styled_up_conv3x3_g20``: ms
    per layer and their sum, the float32 GEMMs' training shapes); and the
    same two at the BagGAN generator's lean width map (``styled_conv3x3_lean``,
    ``styled_up_conv3x3_lean``: every lean row of chip_smoke.py's phase 3
    with Cout <= 64, B = 1 and 8, noise broadcast and per sample, ms per
    call; ``ms`` sums them);
  * sinkhorn_knopp at (patch_size, nprototypes) = (20000, 5000), niters 10,
    ms per call;
  * upfirdn2d at the discriminator's blur shapes and ADA's four SYM6 pass
    shapes (this script's own checkout lists them), ms per call; a
    checkout whose wrapper refuses a case (an older kernel took down = 1
    and at most 8 taps) reports it as null. ``ms`` sums the D shapes.
  * fused_leaky_relu at the discriminator's activation shapes: the forward
    (``fused_act_fwd``) and the autograd backward of the Function
    (``fused_act_bwd``: torch ops in a checkout without the backward
    kernel), ms per call, ``ms`` summing the shapes; and
    ``fused_act_host``: the wrapper's host time per call at the serving
    path's (8, 512) under inference mode, in microseconds (the host clock
    over 1000 calls enqueued without a sync; the card is faster than the
    host there), beside the CUDA-event time per call;
  * resample_rows and its adjoint resample_rows_t at BagGAN-HQ's two pass
    shapes (this turn's checkout's chip_smoke.py draws them from a fixed
    seed), ``ms`` per augment call;
  * the bf16 FIR (``upfirdn2d_bf16``) at the D blur and ADA shapes, ms per
    call, ``ms`` summing the D shapes; at the request's to_rgb upsamples
    (``upfirdn2d_bf16_request``, ms a request of 8); the FIR wrapper's host
    time a call at (8, 128^2, 3), bf16 and float32 (``upfirdn2d_bf16_host``,
    ``upfirdn2d_host``: ``ms`` holds microseconds, as ``fused_act_host``);
    and resample_rows and resample_rows_t in bf16 at the two pass shapes
    (``resample_rows_bf16``, ``resample_rows_t_bf16``, ms an augment call);
  * the bf16 StyledConvs at chip_smoke.py's phase 16 (a) shapes:
    ``styled_conv3x3_bf16`` and ``styled_up_conv3x3_bf16`` at the ffhq-256
    request of 8 (ms per request, each layer's time times its calls, and
    per layer), each call's kernels apart (device time a call under
    torch.profiler): the GEMM (``..._gemm``), the up body's blur epilogue
    (``styled_up_conv3x3_bf16_blur``) and the rest (``..._wrapper``: the
    wrapper's x * s, weight and operand casts, the tap splits' sum); and
    both at the pidray G step's rosinality widths at B = 20 with one noise
    map per sample (``..._g20``, ms per layer and their sum).

And the two host-bound paths, phase 4's request of 8 (``serve``) and phase
5's SwAV step (``swav_step``), and the same request in bf16
(``serve_bf16``: phase 16 (b)'s server, ``inference_dtype='bfloat16'``),
ms on the host clock with the card synced. And one BagGAN-HQ iteration at
the full pidray config (``gan``, ADA p 0.6, iteration 0: D, R1, G and PPL
steps) after a warm-up: device ms per step kind (the trainer's spans,
``utils/tracing.py``, which a checkout must have; ``ms`` is D + R1), then
one more under torch.profiler with each range's kernel time and its elementwise kernels' time (the fused
act's own, PyTorch's elementwise kernels and its reductions), each kernel
in the innermost range it starts in (as chip_smoke.py splits them: ADA's
forward in ``gan.ada``); and the same with ``compute_dtype='bfloat16'``
(``gan_bf16``, ``ms`` its G step). The summary adds the bf16 StyledConvs'
bounds (``bf16_bounds``, ms: the GEMMs' operations at 989 TFLOP/s, the
blur's bytes at 3.35 TB/s), from the shapes alone.

The turns of a round run base, new, new, base. One JSON line per turn, then
the medians per checkout and the ratio new / base. ``--paths-only`` times
only the two host-bound paths, PATHS_ONLY_REQUESTS requests a turn, so that
more rounds fit in a call.

    python3 kernel_ab.py --variants DIR [--out PATH]

times, in one checkout, every lean row (Cout <= 64) of kernels 3 and 4,
and car512's Cout-64 layers at B = 1 and 32, with each variant forced (the
3xTF32 GEMMs, and the narrow kernel with its channel chunks whole and
split 2, 4 and 8 ways, car512's split only where the wrapper would split
them), beside the wrapper's own
choice and the library call
(F.conv2d / F.conv_transpose2d, the conv part only), each with its host
time per call (the host clock over 200 calls enqueued under no_grad
without a sync) and its error against the plain version, the wrapper's
and the library call's device time under torch.profiler: the
measurement the wrapper's choice (``variant``,
``narrow_splits``) is read from.

    python3 kernel_ab.py --fir-plans DIR [--out PATH]

times, in one checkout, the bf16 FIR at the D blur and ADA shapes under
each tile of FIR_PLANS beside the plan's own (``ops/upfirdn2d.py::
_plan_bf16``), with the share of the bytes bound and the float32 kernel's
time: the measurement the bf16 plan is read from.

    python3 kernel_ab.py --backward-threads DIR [--rounds N] [--out PATH]

times, in one checkout, BagGANHQ's D and G steps at the pidray config in
bf16 and float32 (ADA p 0.6, iteration 1), each step's backward on the
calling thread (``BagGANHQ._step``, the trainer's) and on the device's
autograd thread, in alternating turns in one process: what running the
backward on the calling thread costs the steps.

    python3 kernel_ab.py --ops-route DIR [--out PATH]

times, in one checkout, the live ffhq-256 server's request of 8 on the
wrappers (``KERNELS``, what the live paths run) against the same server
with kernels 1-4 through their ``torch.library`` custom ops
(``ops.library.LIBRARY``, what an exported program runs), request by
request in one process, and each of the four's host time a call both ways:
what the custom ops' dispatch would cost the live server.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CONVS = ("styled_conv3x3", "styled_up_conv3x3")
PATHS_ONLY_REQUESTS = 20
HERE = os.path.dirname(os.path.abspath(__file__))


def fir_cases():
    """(case, shape, 2-D kernel as a list, up, down, pad) of the D blur
    shapes and ADA's pass shapes, from this checkout's chip_smoke.py."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from ganecdotes_torch.ops.upfirdn2d import make_kernel

    blur = make_kernel((1, 3, 3, 1)).tolist()
    out = [(case, shape, blur, (1, 1), (1, 1), (p[0], p[1], p[0], p[1]))
           for name, case, shape, p, _ in cs.gan_d_shapes() if name == "upfirdn2d"]
    out += [(case, shape, k.tolist(), up, down, pad)
            for case, shape, k, up, down, pad in cs.gan_fir_shapes() if case.startswith("ADA")]
    sys.path.remove(HERE)
    return out


def time_firs(cs, dev, cases):
    import numpy as np
    import torch

    from ganecdotes_torch.ops import upfirdn2d

    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for case, shape, k, up, down, pad in cases:
        x = torch.randn(*shape, generator=gen, device=dev)
        k = np.asarray(k, np.float32)

        def fn(x=x, k=k, up=up, down=down, pad=pad):
            return upfirdn2d.upfirdn2d(x, k, up=tuple(up), down=tuple(down), pad=tuple(pad))

        try:
            fn()
        except ValueError:  # this checkout's kernel does not take the case
            out[case] = None
            continue
        out[case] = cs.time_ms(fn)
    return out


def host_us_per_call(fn, calls=1000):
    """The host's microseconds a call of ``fn`` under inference mode, the
    calls enqueued without a sync (the card is faster than the host at the
    shapes this is used for)."""
    import torch

    with torch.inference_mode():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def time_bf16_memory(cs, dev, cases):
    """The bf16 FIR at the D blur and ADA cases (``cases``) and at the
    request's to_rgb upsamples (ms a request: each layer's time times its
    calls), the wrapper's host µs a call at (8, 128^2, 3) in bf16 and in
    float32, and the bf16 resample_rows at the two pass shapes (ms an
    augment call)."""
    import numpy as np
    import torch

    from ganecdotes_torch.ops import resample, upfirdn2d

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    firs = {}
    for case, shape, k, up, down, pad in cases:
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        k = np.asarray(k, np.float32)
        firs[case] = cs.time_ms(lambda x=x, k=k, up=up, down=down, pad=pad: upfirdn2d.upfirdn2d(
            x, k, up=tuple(up), down=tuple(down), pad=tuple(pad)))
        del x
    out["upfirdn2d_bf16"] = {"ms": sum(v for c, v in firs.items() if c.startswith("D ")),
                             "cases_ms": firs}
    blur4 = upfirdn2d.make_kernel((1, 3, 3, 1), gain=4.0)
    layers, total = {}, 0.0
    for shape, calls in cs.path_shapes()["upfirdn2d"]:
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        layers[f"to_rgb up {shape[1]}^2"] = ms = cs.time_ms(
            lambda x=x: upfirdn2d.upsample_2d(x, (1, 3, 3, 1)))
        total += ms * calls
    out["upfirdn2d_bf16_request"] = {"ms": total, "cases_ms": layers}
    for dtype, key in ((torch.bfloat16, "upfirdn2d_bf16_host"), (torch.float32, "upfirdn2d_host")):
        x = torch.randn(8, 128, 128, 3, generator=gen, device=dev).to(dtype)
        out[key] = {"ms": host_us_per_call(lambda x=x: upfirdn2d.upfirdn2d(
                        x, blur4, up=2, down=1, pad=(2, 1))),
                    "event_ms_8x128x128x3": cs.time_ms(lambda x=x: upfirdn2d.upfirdn2d(
                        x, blur4, up=2, down=1, pad=(2, 1)))}
    out.update(time_resample(cs, dev, torch.bfloat16))
    return out


def time_fused_act(cs, dev):
    import time

    import torch

    from ganecdotes_torch.ops import fused_act

    gen = torch.Generator(device=dev).manual_seed(5)
    fwd, bwd = {}, {}
    for name, case, shape, _, _ in cs.gan_d_shapes():
        if name != "fused_leaky_relu":
            continue
        x = torch.randn(*shape, generator=gen, device=dev)
        b = torch.randn(shape[-1], generator=gen, device=dev)
        fwd[case] = cs.time_ms(lambda x=x, b=b: fused_act.fused_leaky_relu(x, b))
        xr, br = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fused_act.fused_leaky_relu(xr, br)
        g = torch.randn_like(y)
        bwd[case] = cs.time_ms(lambda y=y, xr=xr, br=br, g=g: torch.autograd.grad(
            y, (xr, br), g, retain_graph=True))
        del xr, br, y, g
    x = torch.randn(8, 512, generator=gen, device=dev)
    b = torch.randn(512, generator=gen, device=dev)
    calls = 1000
    with torch.inference_mode():
        for _ in range(50):
            fused_act.fused_leaky_relu(x, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fused_act.fused_leaky_relu(x, b)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        event_ms = cs.time_ms(lambda: fused_act.fused_leaky_relu(x, b))
    return {"fused_act_fwd": {"ms": sum(fwd.values()), "cases_ms": fwd},
            "fused_act_bwd": {"ms": sum(bwd.values()), "cases_ms": bwd},
            "fused_act_host": {"ms": host_us, "event_ms_8x512": event_ms}}


def time_resample(cs, dev, dtype=None):
    """resample_rows and resample_rows_t at the two pass shapes, float32 or
    ``dtype`` (keys ``..._bf16``), ms an augment call."""
    import torch

    from ganecdotes_torch.ops import resample

    gen = torch.Generator(device=dev).manual_seed(5)
    fwd, adj = {}, {}
    for case, x, alpha, icpt, out_len, calls in cs.resample_cases(dev):
        if calls:
            x = x.to(dtype or x.dtype)
            g = torch.randn(x.shape[0], x.shape[1], out_len, x.shape[3], generator=gen,
                            device=dev).to(x.dtype)
            fwd[case] = cs.time_ms(lambda x=x, a=alpha, i=icpt, n=out_len:
                                   resample.resample_rows(x, a, i, n))
            adj[case] = cs.time_ms(lambda g=g, a=alpha, i=icpt, n=x.shape[2]:
                                   resample.resample_rows_t(g, a, i, n))
    tag = "_bf16" if dtype is torch.bfloat16 else ""
    return {"resample_rows" + tag: {"ms": sum(fwd.values()), "cases_ms": fwd},
            "resample_rows_t" + tag: {"ms": sum(adj.values()), "cases_ms": adj}}


def backward_threads(root, out_path, rounds):
    """The ``--backward-threads`` table: per compute type, ``rounds`` turns
    of each mode (calling thread, device thread; the order alternating),
    each turn two iterations' D and G steps (device ms of each step's span,
    ``utils/tracing.py``), ms per step kind: every turn's median and the
    medians of the turns."""
    import contextlib

    import numpy as np
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.gan.train import BagGANHQ
    from ganecdotes_torch.ops._build import load
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.utils import tracing

    dev = resolve_device("cuda")
    load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    calling = torch.autograd.set_multithreading_enabled
    out = {"card": smi}
    for dtype in ("bfloat16", None):
        cfg = cs.pidray_config(os.path.join(os.getcwd(), "build", "kernel_ab_threads"))
        cfg.compute_dtype = dtype
        gan = BagGANHQ(cfg, seed=0, device=dev, ops=KERNELS)
        gan.ada_state["p"].fill_(0.6)
        rng = np.random.RandomState(3)
        real = (rng.rand(cfg.batch_size, cfg.image_size, cfg.image_size,
                         cfg.num_channels) * 2 - 1).astype(np.float32)
        turns = {"calling": [], "device": []}
        for i in range(rounds + 1):  # a warm-up turn, then the pairs
            order = ("calling", "device") if i % 2 else ("device", "calling")
            for mode in order:
                if mode == "device":
                    torch.autograd.set_multithreading_enabled = (
                        lambda flag: contextlib.nullcontext())
                tracing.reset()
                tracing.start()
                try:
                    for _ in range(2):
                        gan.set_input({"ct": real}, iter_no=1)
                        gan.optimize_parameters()
                finally:
                    torch.autograd.set_multithreading_enabled = calling
                    tracing.stop()
                step_ms = cs.step_readings(tracing.snapshot())["ms"]
                if i:
                    turns[mode].append({k: statistics.median(v)
                                        for k, v in step_ms.items() if v})
        out[dtype or "float32"] = {
            "turns": turns,
            "median": {mode: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
                       for mode, ts in turns.items()}}
        print(json.dumps({dtype or "float32": out[dtype or "float32"]["median"]}), flush=True)
        del gan
        torch.cuda.empty_cache()
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)


ELEMENTWISE_TAGS = {"fused_act": "fused_leaky_relu", "torch_elementwise": "elementwise_kernel",
                    "torch_reduce": "reduce_kernel"}


def gan_iteration(cs, dev, compute_dtype=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ganecdotes_torch.gan.train import BagGANHQ
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.utils import tracing

    cfg = cs.pidray_config(os.path.join(os.getcwd(), "build", "kernel_ab_gan"))
    if compute_dtype:
        cfg.compute_dtype = compute_dtype
    gan = BagGANHQ(cfg, seed=0, device=dev, ops=KERNELS)
    gan.ada_state["p"].fill_(0.6)
    gen = torch.Generator(device=dev).manual_seed(11)
    real = torch.rand(cfg.batch_size, cfg.image_size, cfg.image_size, cfg.num_channels,
                      generator=gen, device=dev) * 2 - 1
    tracing.reset()
    tracing.start()
    try:
        for _ in range(3):  # a warm-up, then two timed iterations
            gan.set_input(real, iter_no=0)
            gan.optimize_parameters()
            torch.cuda.synchronize()
    finally:
        tracing.stop()
    steps = {k: statistics.median(v[1:])
             for k, v in cs.step_readings(tracing.snapshot())["ms"].items() if len(v) > 1}
    gan.set_input(real, iter_no=0)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gan.optimize_parameters()
        torch.cuda.synchronize()
    labels = ("gan.d_step", "gan.r1", "gan.g_step", "gan.ppl", "gan.ada")
    ranges_on_device, kernels = cs.device_ranges(prof)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in ranges_on_device
             if e.name in labels]
    ranges = {lb: {"kernel_ms": 0.0, **dict.fromkeys(ELEMENTWISE_TAGS, 0.0)}
              for lb in labels}
    for e in kernels:  # each kernel in the innermost range it starts in
        inside = [(b - a, lb) for lb, a, b in spans if a <= e.time_range.start < b]
        if not inside:
            continue
        label = min(inside)[1]
        ms = e.time_range.elapsed_us() / 1e3
        ranges[label]["kernel_ms"] += ms
        for kind, tag in ELEMENTWISE_TAGS.items():
            if tag in e.name:
                ranges[label][kind] += ms
    if compute_dtype:
        return {"gan_bf16": {"ms": steps.get("g", 0.0), "step_ms": steps, "ranges": ranges}}
    return {"gan": {"ms": steps.get("d", 0.0) + steps.get("r1", 0.0), "step_ms": steps,
                    "ranges": ranges}}


def kernel_us(fn, calls=20):
    """``fn``'s device time a call per kernel name, in microseconds, under
    torch.profiler (each kernel's spans over ``calls`` calls; the port's
    own spans, ranges on the device, left out)."""
    import torch

    from ganecdotes_torch.utils import tracing
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {sp.name for sp in tracing.snapshot().spans}
    tracing.reset()
    out = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.name not in spans:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def bf16_conv_cases(cs):
    """chip_smoke.py's phase 16 (a) bf16 StyledConv rows at the ffhq-256
    request and the pidray G step's rosinality widths: (key, kernel, shape,
    calls per request (0: summed once), noise batch)."""
    for name, path, shape, calls, noise_b in cs.bf16_styled_shapes():
        if path.startswith("serve"):
            yield f"{name}_bf16", name, shape, calls, noise_b
        elif path == "train rosinality":
            yield f"{name}_bf16_g20", name, shape, 0, noise_b


def time_bf16_convs(cs, dev):
    import torch

    from ganecdotes_torch.ops import modulated_conv

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}

    def add(key, case, ms, calls):
        rec = out.setdefault(key, {"ms": 0.0, "cases_ms": {}})
        rec["cases_ms"][case] = ms
        rec["ms"] += ms * (calls or 1)

    for key, name, shape, calls, noise_b in bf16_conv_cases(cs):
        up = name == "styled_up_conv3x3"
        x, wt, s, demod, noise, nw, bias = cs.styled_inputs(shape, up, gen, dev, noise_b)
        args = [x.to(bf), wt, s.to(bf), demod.to(bf), noise, nw, bias]
        fn = getattr(modulated_conv, name)
        case = str(tuple(shape))
        add(key, case, cs.time_ms(lambda: fn(*args)), calls)
        if calls:  # the kernels apart: GEMM, the up body's blur, the rest
            us = kernel_us(lambda: fn(*args))
            gemm = sum(v for k, v in us.items() if "bf16_kernel" in k) / 1e3
            blur = sum(v for k, v in us.items() if "up_blur_epilogue" in k) / 1e3
            add(key + "_gemm", case, gemm, calls)
            if up:
                add(key + "_blur", case, blur, calls)
            add(key + "_wrapper", case, sum(us.values()) / 1e3 - gemm - blur, calls)
        del x, wt, s, demod, noise, nw, bias, args
    return out


def time_g20_convs(cs, dev):
    """The float32 StyledConvs at the pidray G step's rosinality widths at
    B = 20, one noise map per sample (chip_smoke.py's phase 16 (a) shapes,
    float32): ``styled_conv3x3_g20`` and ``styled_up_conv3x3_g20``, ms per
    layer and their sum."""
    import torch

    from ganecdotes_torch.ops import modulated_conv

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, path, shape, _, noise_b in cs.bf16_styled_shapes():
        if path != "train rosinality":
            continue
        args = cs.styled_inputs(shape, name == "styled_up_conv3x3", gen, dev, noise_b)
        fn = getattr(modulated_conv, name)
        rec = out.setdefault(f"{name}_g20", {"ms": 0.0, "cases_ms": {}})
        rec["cases_ms"][str(tuple(shape))] = ms = cs.time_ms(lambda: fn(*args))
        rec["ms"] += ms
        del args
    return out


def bf16_bounds(cs):
    """The bf16 StyledConvs' bounds per key of ``time_bf16_convs`` (ms,
    summed like its ``ms``): the GEMMs' 2 * 9 * Cin * Cout flops a pixel at
    989 TFLOP/s; the up body's blur epilogue its bytes at 3.35 TB/s (T read
    once in float32, the noise map and bias, the bf16 output written once)."""
    out = {}
    for key, name, (b, h, w, ci, co), calls, noise_b in bf16_conv_cases(cs):
        n = calls or 1
        gemm = 2 * b * h * w * 9 * ci * co / 989e12 * 1e3
        out[key] = out.get(key, 0.0) + gemm * n
        if calls:
            out[key + "_gemm"] = out.get(key + "_gemm", 0.0) + gemm * n
        if name == "styled_up_conv3x3" and calls:
            nbytes = (4 * b * (2 * h + 1) * (2 * w + 1) * co + 4 * noise_b * 4 * h * w
                      + 4 * co + 2 * b * 4 * h * w * co)
            out[key + "_blur"] = out.get(key + "_blur", 0.0) + nbytes / 3.35e12 * 1e3 * n
    return out


def paths(cs, dev, requests=6):
    """Phase 4's request of 8 z through the folded ffhq-256 server
    (``serve``), the same in bf16 (``serve_bf16``) and phase 5's SwAV step
    at the full config (``swav_step``, ``run_pretrain``'s 1 + 4 steps): ms,
    host clock with the card synced, the median after the first."""
    import torch

    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.pipeline.serving import OneShotServer

    timed = {}
    for key, dtype in (("serve", None), ("serve_bf16", "bfloat16")):
        server = OneShotServer(device=dev, seed=0, **({"dtype": dtype} if dtype else {}))
        ms = []
        for i in range(requests):
            z = torch.randn(8, 512, generator=torch.Generator().manual_seed(100 + i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.serve(z)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timed[key] = {"ms": statistics.median(ms[1:]), "request_ms": ms}
        del server
    mc, _, _, _ = cs.swav_configs()
    gen = Generator(**mc.gen_args, generator=torch.Generator().manual_seed(0)).to(dev)
    _, step_ms = cs.run_pretrain(gen, dev, KERNELS)
    return {**timed,
            "swav_step": {"ms": statistics.median(step_ms[1:]), "step_ms": step_ms}}


def lean_conv_cases(cs):
    """chip_smoke.py's lean rows of kernels 3 and 4 with Cout <= 64:
    (kernel, shape, noise batch)."""
    return [(name, shape, noise_b) for path, name, shape, _, noise_b in cs.kernel_cases()
            if path == "baggan-lean" and name in CONVS and shape[4] <= 64]


# car512's Cout-64 layers, its 512^2 level (the up conv 128 -> 64 from
# 256^2, the conv 64 -> 64), at B = 1 and 32 (a request): (kernel, shape,
# noise batch)
CAR512_CASES = [(name, (b, r, r, ci, 64), 1) for b in (1, 32)
                for name, r, ci in (("styled_up_conv3x3", 256, 128),
                                    ("styled_conv3x3", 512, 64))]


def time_lean_convs(cs, dev):
    import torch

    from ganecdotes_torch.ops import modulated_conv

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {name: {} for name in CONVS}
    for name, shape, noise_b in lean_conv_cases(cs):
        fn = getattr(modulated_conv, name)
        args = cs.styled_inputs(shape, name == "styled_up_conv3x3", gen, dev, noise_b)
        out[name][f"{tuple(shape)} noise_b {noise_b}"] = cs.time_ms(lambda: fn(*args))
    return {f"{name}_lean": {"ms": sum(v.values()), "cases_ms": v}
            for name, v in out.items()}


def host_us(fn, calls=200):
    """``fn``'s host time a call in microseconds: the host clock over
    ``calls`` calls enqueued under no_grad without a sync (after 20 more),
    then one sync outside the clock."""
    import time

    import torch

    with torch.no_grad():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def device_us(fn, calls=20):
    """``fn``'s kernels' device time a call in microseconds, under
    torch.profiler (the sum of the kernels' spans over ``calls`` calls)."""
    return sum(kernel_us(fn, calls).values())


def lean_variants(root, out_path):
    """The ``--variants`` table (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)
    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import modulated_conv as mc
    from ganecdotes_torch.ops._build import load

    dev = resolve_device("cuda")
    load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    cases = [(c, False) for c in lean_conv_cases(cs)]
    for (name, shape, noise_b), car in cases + [(c, True) for c in CAR512_CASES]:
        up = name == "styled_up_conv3x3"
        args = cs.styled_inputs(shape, up, gen, dev, noise_b)
        want = getattr(mc, name + "_ref")(*args)
        b, h, w, ci, co = shape
        f = 2 if up else 1
        taps = mc._blur_taps(name, (1, 3, 3, 1))
        out_shape = (b, f * h, f * w, co)
        wrapper = getattr(mc, name)
        cands = {"wrapper": lambda: wrapper(*args)}
        if up:
            cands["tf32x3"] = lambda: mc._tf32x3_up_conv_forward(*args, taps, out_shape)
        else:
            cands["tf32x3"] = lambda: mc._tf32x3_conv_forward(*args, out_shape)
        splits = mc.narrow_splits(b, h, w, ci, co, up, sms)
        for n in (1, 2, 4, 8):
            if n <= -(-ci // 16) and (n == 1 or splits > 1 or not car):
                cands[f"narrow_s{n}"] = lambda n=n: mc._narrow_forward(
                    name, *args, up=up, taps=taps, nsplit=n)
        xm = (args[0] * args[2][:, None, None, :]).permute(0, 3, 1, 2)
        if up:
            wl = args[1].permute(2, 3, 0, 1).contiguous()
            cands["library"] = lambda: F.conv_transpose2d(xm, wl, stride=2)
        else:
            wl = args[1].permute(3, 2, 0, 1).contiguous()
            cands["library"] = lambda: F.conv2d(xm, wl, padding=1)
        row = {"kernel": name, "shape": list(shape), "noise_b": noise_b,
               "variant": mc.variant(co, up, b * h * w, sms),
               "narrow_splits": splits}
        for key, fn in cands.items():
            got = fn()
            torch.cuda.synchronize()
            err = None if key == "library" else cs.errors(got, want)[0]
            row[key] = {"ms": cs.time_ms(fn), "err": err, "host_us": host_us(fn)}
        for key in ("wrapper", "library"):
            row[key]["device_us"] = device_us(cands[key])
        row["wrapper_host_us"] = row["wrapper"]["host_us"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


# (toh, tow, ct or None for the plan's own, threads) for --fir-plans: 8
# channels a thread (the D blurs), then 1 or 4 (ADA's passes, C = 3)
FIR_PLANS = {8: [(4, 16, 64, 128), (8, 16, 64, 256), (8, 32, 32, 256), (4, 16, 32, 128),
                 (8, 16, 32, 128), (4, 8, 64, 64), (4, 16, 128, 256)],
             1: [(8, 64, None, 256), (8, 128, None, 256), (16, 64, None, 256),
                 (4, 128, None, 256), (16, 128, None, 256)],
             4: [(8, 128, None, 256), (16, 128, None, 256), (8, 64, None, 256),
                 (4, 128, None, 128), (16, 64, None, 256)]}


def fir_plans(root, out_path):
    """The ``--fir-plans`` table: the bf16 FIR at the D blur and ADA shapes
    (``fir_cases``) under each tile of FIR_PLANS for its channels a thread,
    beside the plan's own, ms (CUDA events), the share of the bytes bound
    and the float32 kernel's ms; each tile's output checked bit-equal to the
    plan's own (the tile moves no sum)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import upfirdn2d as tup
    from ganecdotes_torch.ops._build import load

    dev = resolve_device("cuda")
    load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    own = tup._plan_bf16
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for case, shape, k, up, down, pad in fir_cases():
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        k = np.asarray(k, np.float32)
        up, down, pad = tup._normalize_args(up, down, pad)

        def run(x=x, k=k, up=up, down=down, pad=pad):
            return tup.upfirdn2d(x, k, up=up, down=down, pad=pad)

        def replan(tile):
            def plan(c, kh, kw, up_, down_, tile=tile):
                p = own(c, kh, kw, up_, down_)
                if tile is None or p.vec != vec:
                    return p
                toh, tow, ct, threads = tile
                ct = p.ct if ct is None else min(c, ct)
                threads -= threads % (ct // p.vec)
                ih = tup._extent(toh, kh, up_[1], down_[1]) if p.vpass else toh
                iw = tup._extent(tow, kw, up_[0], down_[0])
                return p._replace(toh=toh, tow=tow, ct=ct, ih=ih, iw=iw, threads=threads,
                                  smem=tup.smem_bf16(ih, iw, toh, ct, p.vpass))
            tup._plan_bf16 = plan
            tup.plan.cache_clear()
            tup._LAUNCHES.clear()

        replan(None)
        want = run()
        vec = tup.plan(*cs._fir_plan_key(shape, k, up, down, pad)).vec
        moved = 2 * (x.numel() + want.numel())
        bound = cs.bound_ms(moved, [(1, cs.FP32)])[0]
        x32 = x.float()
        row = {"case": case, "shape": list(shape), "vec": vec, "bound_ms": bound,
               "fp32_ms": cs.time_ms(lambda: tup.upfirdn2d(x32, k, up, down, pad)),
               "tiles": {}}
        del x32
        for tile in [None] + FIR_PLANS[vec]:
            replan(tile)
            got = run()
            torch.cuda.synchronize()
            ms = cs.time_ms(run)
            row["tiles"]["plan" if tile is None else "x".join(map(str, tile))] = {
                "ms": ms, "bound_share": bound / ms, "bit_equal": bool(torch.equal(got, want))}
        replan(None)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, want
    tup._plan_bf16 = own
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


def ops_route(root, out_path, requests=40):
    """In one checkout: phase 4's request of 8 through the live server on
    ``KERNELS`` and through the same server on ``ops.library.LIBRARY``
    (kernels 1-4 through their custom ops, as an exported program calls
    them), the two alternating request by request (host clock, the card
    synced; which goes first alternates too), their labels compared; and
    kernels 1-4's host time a call through the wrapper and through the
    op (``host_us``) at one shape of the request each."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import fused_act, library, modulated_conv
    from ganecdotes_torch.ops import upfirdn2d as fir
    from ganecdotes_torch.ops._build import load
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.pipeline.serving import OneShotServer

    dev = resolve_device("cuda")
    load()
    server = OneShotServer(device=dev, seed=0)
    routes = (("kernels", KERNELS), ("library", library.LIBRARY))
    ms = {name: [] for name, _ in routes}
    labels_equal = True
    for i in range(requests + 1):  # request 0 of each: warm-up
        z = torch.randn(8, 512, generator=torch.Generator().manual_seed(100 + i))
        labels = []
        for name, ops in (routes if i % 2 else routes[::-1]):
            server.ops = ops
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels.append(server.serve(z)[1])
            torch.cuda.synchronize()
            if i:
                ms[name].append((time.perf_counter() - t0) * 1e3)
        labels_equal &= bool(torch.equal(*labels))
    server.ops = KERNELS
    gen = torch.Generator(device=dev).manual_seed(0)
    x, b = torch.randn(8, 512, generator=gen, device=dev), torch.randn(512, generator=gen,
                                                                       device=dev)
    rgb = torch.randn(8, 128, 128, 3, generator=gen, device=dev)
    conv = cs.styled_inputs((8, 64, 64, 512, 512), False, gen, dev)
    up = cs.styled_inputs((8, 64, 64, 512, 256), True, gen, dev)
    calls = {
        "fused_leaky_relu (8, 512)": (lambda: fused_act.fused_leaky_relu(x, b),
                                      lambda: library.fused_leaky_relu(x, b)),
        "upfirdn2d upsample (8, 128, 128, 3)": (
            lambda: fir.upsample_2d(rgb),
            lambda: fir.upsample_2d(rgb, impl=library.upfirdn2d)),
        "styled_conv3x3 (8, 64, 64, 512, 512)": (
            lambda: modulated_conv.styled_conv3x3(*conv),
            lambda: library.styled_conv3x3(*conv)),
        "styled_up_conv3x3 (8, 64, 64, 512, 256)": (
            lambda: modulated_conv.styled_up_conv3x3(*up),
            lambda: library.styled_up_conv3x3(*up)),
    }
    host = {case: {"wrapper_us": host_us(w), "op_us": host_us(o)}
            for case, (w, o) in calls.items()}
    diffs = [lib - ker for ker, lib in zip(ms["kernels"], ms["library"])]
    out = {"requests": requests, "labels_equal": labels_equal,
           "request_ms": {name: statistics.median(v) for name, v in ms.items()},
           "library_minus_kernels_ms": {
               "median": statistics.median(diffs),
               "quartiles": statistics.quantiles(diffs, n=4)},
           "host_us": host, "all_request_ms": ms}
    print(json.dumps(out), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)


def worker(root, cases, paths_only=False):
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import modulated_conv, sinkhorn
    from ganecdotes_torch.ops._build import load

    dev = resolve_device("cuda")
    load()
    if paths_only:
        print(json.dumps(paths(cs, dev, requests=PATHS_ONLY_REQUESTS)), flush=True)
        return
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, shapes in cs.path_shapes().items():
        if name not in CONVS:
            continue
        fn = getattr(modulated_conv, name)
        layers = []
        for shape, calls in shapes:
            args = cs.styled_inputs(shape, name == "styled_up_conv3x3", gen, dev)
            layers.append((cs.time_ms(lambda fn=fn, args=args: fn(*args)), calls))
        out[name] = {"ms": sum(ms * n for ms, n in layers),
                     "layers_ms": [ms for ms, _ in layers]}
    _, _, sa, sk = cs.swav_configs()
    b, k, nc = sa["patch_size"], sa["nprototypes"], sa["nclasses"]
    z = torch.nn.functional.normalize(torch.randn(b, nc, generator=gen, device=dev), dim=1)
    p = torch.nn.functional.normalize(torch.randn(nc, k, generator=gen, device=dev), dim=0)
    x = (z @ p).contiguous()
    r, c = torch.ones(k, device=dev) / k, torch.ones(b, device=dev) / b
    out["sinkhorn_knopp"] = {"ms": cs.time_ms(
        lambda: sinkhorn.sinkhorn_knopp(x, sk["niters"], sk["eps"], r, c))}
    out.update(time_g20_convs(cs, dev))
    out.update(time_lean_convs(cs, dev))
    out.update(time_bf16_convs(cs, dev))
    firs = time_firs(cs, dev, cases)
    out["upfirdn2d"] = {"ms": sum(v for k, v in firs.items() if k.startswith("D ")),
                        "cases_ms": firs}
    out.update(time_fused_act(cs, dev))
    out.update(time_resample(cs, dev))
    out.update(time_bf16_memory(cs, dev, cases))
    out.update(gan_iteration(cs, dev))
    out.update(gan_iteration(cs, dev, "bfloat16"))
    out.update(paths(cs, dev))
    print(json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("base", nargs="?")
    parser.add_argument("new", nargs="?")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--out", help="write the turns and the summary to this JSON file")
    parser.add_argument("--variants", metavar="DIR",
                        help="time every lean StyledConv variant in this checkout")
    parser.add_argument("--fir-plans", metavar="DIR",
                        help="time the bf16 FIR's tiles at the D and ADA shapes "
                             "in this checkout")
    parser.add_argument("--backward-threads", metavar="DIR",
                        help="time the GAN steps with the backward on the calling "
                             "thread and on the device's thread in this checkout")
    parser.add_argument("--ops-route", metavar="DIR",
                        help="time the live server on the wrappers against "
                             "the custom ops in this checkout")
    parser.add_argument("--paths-only", action="store_true",
                        help="time only the request of 8 and the SwAV step "
                             f"({PATHS_ONLY_REQUESTS} requests a turn)")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--cases", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.variants:
        lean_variants(os.path.abspath(args.variants), args.out)
        return 0
    if args.ops_route:
        ops_route(os.path.abspath(args.ops_route), args.out)
        return 0
    if args.fir_plans:
        fir_plans(os.path.abspath(args.fir_plans), args.out)
        return 0
    if args.backward_threads:
        backward_threads(os.path.abspath(args.backward_threads), args.out, args.rounds)
        return 0
    if not (args.base and args.new):
        parser.error("give BASE_DIR and NEW_DIR, --variants DIR, --fir-plans DIR, "
                     "--backward-threads DIR or --ops-route DIR")
    if args.worker:
        worker(os.path.abspath(args.worker), json.loads(args.cases), args.paths_only)
        return 0
    cases = json.dumps(fir_cases())
    turns = []
    for _ in range(args.rounds):
        for side in ("base", "new", "new", "base"):
            root = os.path.abspath(getattr(args, side))
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "x", "x",
                                  "--worker", root, "--cases", cases]
                                 + (["--paths-only"] if args.paths_only else []),
                                 cwd=root, capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stderr[-8000:])
                raise SystemExit(f"the {side} turn in {root} failed ({res.returncode})")
            turn = {"side": side, **json.loads(res.stdout.strip().splitlines()[-1])}
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    summary = {}
    for kernel in [k for k in turns[0] if k != "side"]:
        med = {side: statistics.median(t[kernel]["ms"] for t in turns if t["side"] == side)
               for side in ("base", "new")}
        summary[kernel] = {**med, "new_over_base": med["new"] / med["base"]}
        if "cases_ms" not in turns[0][kernel]:
            continue
        cases_ms = {}
        for case in turns[0][kernel]["cases_ms"]:
            cases_ms[case] = {}
            for side in ("base", "new"):
                vals = [t[kernel]["cases_ms"][case] for t in turns if t["side"] == side]
                cases_ms[case][side] = None if None in vals else statistics.median(vals)
        summary[kernel]["cases_ms"] = cases_ms
    if args.paths_only:
        turns_ms = {path: {side: [t[path]["ms"] for t in turns if t["side"] == side]
                           for side in ("base", "new")}
                    for path in ("serve", "serve_bf16", "swav_step")}
        summary["turns_ms"] = turns_ms
        return _write(args.out, turns, summary)
    for gan in ("gan", "gan_bf16"):
        summary[gan]["step_ms"] = {
            kind: {side: statistics.median(t[gan]["step_ms"][kind] for t in turns
                                           if t["side"] == side) for side in ("base", "new")}
            for kind in turns[0][gan]["step_ms"]}
        summary[gan]["ranges"] = {
            label: {key: {side: statistics.median(t[gan]["ranges"][label][key]
                                                  for t in turns if t["side"] == side)
                          for side in ("base", "new")}
                    for key in turns[0][gan]["ranges"][label]}
            for label in turns[0][gan]["ranges"]}
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    summary["bf16_bounds"] = bf16_bounds(cs)
    return _write(args.out, turns, summary)


def _write(out_path, turns, summary):
    print(json.dumps({"summary": summary}))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
