#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its serving, SwAV
pretraining, BagGAN training and one-shot evaluate paths, the other four
segmentation methods' pretrain and evaluate paths, and the evaluate path
of other model configs from reference-format checkpoints, on one GPU.

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
     computes the same function, and its bound (at the rate of the
     arithmetic the kernel runs in: 3xTF32 on the tensor cores for both
     StyledConvs' GEMMs, fp32 SIMT otherwise; the non-up conv's fp32 SIMT
     figure is printed beside it); the blur and the fused bias + leaky-ReLU
     at the shapes BagGAN-HQ's discriminator gives them, and the FIR kernel
     at BagGAN-HQ's other FIRs: ADA's four SYM6 passes, the PPL
     composite's blur at each up layer and the to_rgb upsample's down-2
     backward (all measured only, not summed per request); the Sinkhorn kernel at the pretraining path's
     (patch_size, nprototypes) scores, uniform and image marginals, a
     ragged shape, niters = 0 and the generic K = 8000, each launched twice
     and required equal bit for bit, within 1e-4 and 0.1/K of its plain
     version, and the kernel one iteration short required to miss 0.1/K;
     the four serving kernels also at the shapes the BagGAN generator's
     lean width map gives them (16 channels at 256^2, 32 at 128^2), at
     B = 1 and B = 8, the StyledConvs' noise broadcast and (the narrowest
     layers) one map per sample: gated, measured, not summed per request;
  4. serve: OneShotServer (ffhq-256, hfc_with_swav, random weights from a
     seed) answers 3 requests of 8 z through the folded projection + head
     with every kernel's launch counted; the folded requests are held
     against the unfused ones (projection, then head: the image bit-equal,
     logits within 1e-4, labels 99.9%) and both are timed, as is the
     request's 64^2 polyphase conv by F.conv2d against the port's matmul
     form; then a server
     with every op on its plain version on the card, its mean latent drawn
     anew from the same seed, answers the same requests;
  5. pretrain: SwAVClustering at the full hfc_with_swav ffhq config (random
     generator from a seed) takes 1 warm-up and 4 timed steps with every
     kernel's launch counted, saves and reloads swav_params.npz, and the same
     steps from the same seed run again with every op on its plain version;
     one more step runs under torch.profiler;
  6. the ADA warp pass and its adjoint at the two pass shapes BagGAN-HQ's
     augment gives them at 256^2, B = 20 (the pass geometry from ADA draws
     at p = 1: flips, transposed images), a small ragged flipped case and
     small cases at alpha = 0 and 0.05: each kernel against its plain
     version, two launches of the adjoint bit for bit, the adjoint
     identity, and the times of kernel, plain version, F.grid_sample (the
     adjoint: grid_sampler_2d_backward) and the bound;
  7. train: BagGANHQ at the full pidray config (random weights and "real"
     batches from a seed, ADA p set to 0.6) for 5 iterations (R1 and PPL at
     iteration 0, PPL at 4) with every kernel's launch counted per step
     kind, then again with every op on its plain version; iteration 0's
     gradients of each step kind and every iteration's losses held against
     the plain run; the grouped (depthwise) F.conv2d calls on the card per
     step kind, none with the kernels; one more iteration (all four step
     kinds) under torch.profiler, with the FIR kernel's and cuDNN's
     grouped-conv kernels' device time per range;
  8. evaluate: cli/evaluate.py's path at ffhq-256 (OneShotPipeline,
     hfc_with_swav_ffhq, the supervised trainer's 200 epochs, phase 5's
     generator and swav_params.npz, 16 synthesised test samples + the
     one-shot one): setup, the one-shot features, the fine-tune, prediction
     (2 requests of 8, also timed unfused) and scoring, with the kernels and
     again with every op on its plain version; the features, the fine-tune
     losses, the test labels and the mean mask IoU held against the plain
     run; 10 more fine-tune epochs under torch.profiler;
  9. methods: RepurposeGAN, DatasetGAN, hfc_with_simclr and hfc_kmeans at
     ffhq-256, each with the kernels and again with every op on its plain
     version: SimCLR's pretraining (5 of its 100 steps; step losses held
     to 1e-5) and the k-means fit at the shipped config (its block
     features held to 1e-3; the plain fit runs on the kernels fit's
     features with its k-means++ picks, centers held to 1e-3), then
     cli/evaluate.py's path on the kernels run's pretrained files (16 test
     samples, 200 fine-tune epochs) held with phase 8's gates (the one-shot
     features of each run, k-means' one-hot ones by their agreement; the
     plain run fine-tunes on the kernels run's features, since one
     rounding step of them moves the 200 epochs past the loss and label
     gates: method_rounding.py), the folded request against its unfused
     oracle, 3 timed requests of each, and RepurposeGAN's fine-tune epoch
     with the head's first conv by cuDNN and by the matmul form;
 10. configs: (a) a rosinality g_ema .pt written from a seeded full-width
     generator loads through cat-256's model_path, and with the kernels its
     pipeline's one-shot image, features and mean latent equal, bit for
     bit, those of a pipeline given the source generator; phase 5's SwAV
     params written as the reference's prototypes.pt / projection.pt
     import bit-equal; (b) p-horse-256 (a g_ema .pt, per-layer NCHW noise
     .pt files at sample_noises, the generic hfc_with_swav config's SwAV
     params from the reference's files) and (c) pidray-256 (a lean-map
     BagGAN latest_net_G.pth written by save_baggan_torch_checkpoint, a
     run config with res2chlmap = "baggan", hfc_with_swav_pidray's SwAV
     params from the reference's files) through cli/evaluate.py's path
     with the kernels and the plain ops, with phase 9's gates and replay;
     (b) checks that the fed noise reached the untruncated one-shot
     synthesis, (c) that a latest_net_G.npz of the same generator loads
     bit-equal and a lean random init is hlen wide;
 11. one JSON line of the kernels, then the result line.

``--details PATH`` also writes every shape's numbers, the build record and
the serving, pretraining, training, evaluate, methods and configs records
to a JSON file.
"""

import argparse
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import types
from contextlib import contextmanager

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8  # MAX_TEST_BATCH, one request
N_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
# the arithmetic each kernel's operations run in, and its peak rate
FP32 = ("fp32 SIMT", FP32_FLOPS)
TF32X3 = ("3xTF32 tensor cores", TF32_FLOPS)
# kernel vs plain version: both float32, different summation order; the
# error stays within a few ulps of the largest partial sums
KERNEL_TOL = 1e-4  # max |kernel - plain| <= KERNEL_TOL * max(1, max |plain|)
IMAGE_TOL = 1e-3  # same measure for the served image after 13 conv layers
LABEL_AGREEMENT = 0.999
SINKHORN_TOL = 1e-4  # absolute, on codes in [0, 1]
# and scaled to the codes: each row sums to 1 over K, so the mean code is
# 1/K, and 1e-4 alone is half a mean code at K = 5000. A planted fault (the
# kernel one iteration short) must exceed this gate.
SINKHORN_CODE_TOL = 0.1  # max |kernel - plain| <= SINKHORN_CODE_TOL / K
PRETRAIN_STEPS = 4  # timed, after one warm-up step
# KERNELS vs PLAIN pretraining run, per-step loss and final params (see
# check_pretrain_agreement for the reason)
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_TOL = 1e-6  # max |kernels - plain| <= STEP_PARAM_TOL * max(1, max |plain|)

KERNELS_TABLE = {
    "fused_leaky_relu": ("ganecdotes_torch/csrc/fused_act.cu",
                         "ganecdotes_tpu/ops/fused_act.py:72"),
    # row 1's backward: the JAX package's custom_vjp backward _flr_bwd (jnp
    # there), the same Function in the port, not a Pallas kernel of its own
    "fused_leaky_relu_bwd": ("ganecdotes_torch/csrc/fused_act.cu",
                             "ganecdotes_tpu/ops/fused_act.py:87"),
    "upfirdn2d": ("ganecdotes_torch/csrc/upfirdn2d.cu",
                  "ganecdotes_tpu/ops/upfirdn2d_pallas.py:132"),
    "styled_conv3x3": ("ganecdotes_torch/csrc/styled_conv.cu",
                       "ganecdotes_tpu/ops/modulated_conv_pallas.py:317"),
    "styled_up_conv3x3": ("ganecdotes_torch/csrc/styled_up_conv.cu",
                          "ganecdotes_tpu/ops/modulated_conv_pallas.py:564"),
    "sinkhorn_knopp": ("ganecdotes_torch/csrc/sinkhorn.cu",
                       "ganecdotes_tpu/ops/sinkhorn_pallas.py:380"),
    "resample_rows": ("ganecdotes_torch/csrc/affine_warp.cu",
                      "ganecdotes_tpu/ops/affine_warp_pallas.py:296"),
    "resample_rows_t": ("ganecdotes_torch/csrc/affine_warp.cu",
                        "ganecdotes_tpu/ops/affine_warp_pallas.py:328"),
}
SERVING_KERNELS = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
                   "styled_up_conv3x3")
PRETRAIN_KERNELS = SERVING_KERNELS + ("sinkhorn_knopp",)
RESAMPLE_KERNELS = ("resample_rows", "resample_rows_t")
KERNEL_NOTES = {"fused_leaky_relu_bwd": "row 1's backward (_flr_bwd, jnp in the "
                                        "JAX package), not a separate Pallas kernel"}
GAN_B = 20  # the pidray config's batch
GAN_SIZE = 256  # and its image side
GAN_ITERS = 5
ADA_P = 0.6  # the shipped augment_p = 0 draws identity warps for ages
# the pass: kernel and plain version take the same rounded steps; the
# adjoint sums the same products in another order
RESAMPLE_TOL = 1e-5  # max |kernel - plain| <= RESAMPLE_TOL * max(1, max |plain|)
ADJOINT_TOL = 1e-5  # |<A x, g> - <x, A^T g>| <= ADJOINT_TOL * ||A x|| ||g||
# KERNELS vs PLAIN training run (see check_gan_agreement for the reasons):
# iteration 0's gradients, each tensor's ||kernels - plain|| against the
# norm of its step's whole plain gradient; the D step's from equal weights,
# R1's, G's and PPL's after 1, 2 and 3 Adam updates
GAN_GRAD_TOL = {"d": 2e-3, "r1": 3e-2, "g": 3e-2, "ppl": 3e-2}
GAN_LOSS_TOL = 1e-5  # the first D loss, |kernels - plain| / max(1, |plain|)
GAN_DRIFT_TOL = 2e-2  # every later loss, the same measure


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


def bound_ms(nbytes, ops):
    """The least time for the work: the bytes over the memory rate, or the
    operations over the peak rate of the arithmetic they run in, whichever
    is larger. ``ops`` lists (operations, (arithmetic, rate)). Returns (ms,
    "bytes" or "operations (the arithmetic and its rate)")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = sum(n / arith[1] for n, arith in ops) * 1e3
    if t_b >= t_f:
        return t_b, "bytes"
    rate = " + ".join(f"{arith[0]} {arith[1] / 1e12:g} TFLOP/s" for _, arith in ops)
    return t_f, f"operations ({rate})"


def tensor_core_instructions(library):
    """HMMA (tensor-core MMA) instructions per kernel in the built library's
    SASS, by cuobjdump next to nvcc (the same toolkit: it fails if missing)."""
    from ganecdotes_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "HMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


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


def lean_shapes():
    """Per kernel, the (shape, noise batch) the BagGAN generator at the
    reference's lean width map (16 channels at 256^2, 32 at 128^2) gives it
    on the pidray path, at B = 1 (the one-shot synthesis) and B = 8 (a
    request), the noise broadcast over the batch as served; the two
    narrowest layers and the up layer between them also with one noise map
    per sample. Measured and gated, not summed into a request."""
    from ganecdotes_torch.models.baggan.convert import BAGGAN_RES_TO_CHANNEL_MAP as ch

    res = [2**k for k in range(2, GAN_SIZE.bit_length())]  # 4 .. 256
    out = {"fused_leaky_relu": [((1, 512), 1)],
           "upfirdn2d": [((1, r, r, 3), 1) for r in res[:-1]],
           "styled_conv3x3": [], "styled_up_conv3x3": []}
    for b in (1, B):
        out["styled_conv3x3"] += [((b, r, r, ch[r], ch[r]), 1) for r in res]
        out["styled_up_conv3x3"] += [((b, r // 2, r // 2, ch[r // 2], ch[r]), 1)
                                     for r in res[1:]]
    out["styled_conv3x3"] += [((B, r, r, ch[r], ch[r]), B) for r in (128, 256)]
    out["styled_up_conv3x3"].append(((B, 128, 128, ch[128], ch[256]), B))
    return out


def kernel_cases():
    """(path, kernel, shape, calls per request, noise batch): the ffhq-256
    serving path's shapes, then the lean map's that it has not (calls 0:
    measured only)."""
    seen = set()
    for name, shapes in path_shapes().items():
        for shape, calls in shapes:
            seen.add((name, shape, 1))
            yield "ffhq-256", name, shape, calls, 1
    for name, shapes in lean_shapes().items():
        for shape, noise_b in shapes:
            if (name, shape, noise_b) not in seen:
                yield "baggan-lean", name, shape, 0, noise_b


def styled_inputs(shape, up, gen, dev, noise_b=1):
    b, h, w, ci, co = shape
    f = 2 if up else 1
    x = torch.randn(b, h, w, ci, generator=gen, device=dev)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    s = 1.0 + 0.3 * torch.randn(b, ci, generator=gen, device=dev)
    demod = torch.rsqrt(s.square() @ wt.square().sum((0, 1)) + 1e-8)
    noise = torch.randn(noise_b, f * h, f * w, 1, generator=gen, device=dev)
    nw = torch.full((), 0.3, device=dev)
    bias = 0.1 * torch.randn(co, generator=gen, device=dev)
    return [x, wt, s, demod, noise, nw, bias]


def check_kernels(dev):
    import torch.nn.functional as F

    from ganecdotes_torch.ops import fused_act, modulated_conv, upfirdn2d

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for path, name, shape, calls, noise_b in kernel_cases():
        lib = None  # one PyTorch call as a yardstick, where there is one
        other = None  # a second plain form, where the path has one
        simt = None  # a StyledConv's bound at fp32 SIMT rates
        if name == "fused_leaky_relu":
            x = torch.randn(*shape, generator=gen, device=dev)
            bias = torch.randn(shape[-1], generator=gen, device=dev)

            def kern(x=x, bias=bias):
                return fused_act.fused_leaky_relu(x, bias)

            def plain(x=x, bias=bias):
                return fused_act.fused_leaky_relu_ref(x, bias)

            moved = nbytes(x, bias, x)
            flops = 3 * x.numel()
            ops = [(flops, FP32)]
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
            ops = [(flops, FP32)]
        else:
            up = name == "styled_up_conv3x3"
            args = styled_inputs(shape, up, gen, dev, noise_b)
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
            # quarter of the MACs of the four composed phase filters.
            # Both GEMMs run in 3xTF32: three tensor-core products per
            # multiply-add.
            flops = 2 * b * h * w * 9 * ci * co
            ops = [(3 * flops, TF32X3)]
            # the same work at fp32 SIMT rates, for comparison
            simt = bound_ms(moved, [(flops, FP32)])[0]
            if up:
                # the 4x4 blur is separable: 4 taps across the 2H + 1
                # scratch rows, then 4 down, per output channel
                blur = 2 * b * co * 4 * (2 * w) * ((2 * h + 1) + 2 * h)
                ops.append((blur, FP32))
                flops += 2 * b * (2 * h) * (2 * w) * co * 16  # as a 2-D filter
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
            "kernel": name, "path": path, "shape": list(shape),
            "noise_b": noise_b, "calls": calls,
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
        row["bound_ms"], row["bound_by"] = bound_ms(moved, ops)
        row["bound_fp32_simt_ms"] = simt
        if name == "styled_conv3x3":  # how many ways the kernel split its taps
            b, h, w, _, co = shape
            row["tap_splits"] = modulated_conv.tap_splits(
                b * h * w, co, torch.cuda.get_device_properties(dev).multi_processor_count)
        row["bytes"], row["flops"] = moved, flops
        rows.append(row)
        print(f"  {name:18s} {str(tuple(shape)):26s}"
              + ("" if path == "ffhq-256" else f" [{path}, noise_b {noise_b}]")
              + f" err {err:.3e} "
              f"(rel {rel:.2e}, tol {tol:.1e}"
              + ("" if other_err is None else f"; vs convT+blur {other_err:.3e}")
              + ") "
              f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
              f"lib {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})"
              + ("" if simt is None else f" [fp32 SIMT {simt:.4f}]")
              + (f" taps split {row['tap_splits']}" if "tap_splits" in row else ""),
              flush=True)
        check(ok, f"{name} {shape}: max abs err {err} (vs convT+blur "
                  f"{other_err}) over tolerance {tol}")
    return rows


def gan_d_shapes():
    """The blur's and the fused bias + leaky-ReLU's calls in one forward of
    BagGAN-HQ's discriminator at the pidray config (256^2, B = 20):
    (kernel, case, shape, pad or None, calls per D forward). Each ResBlock
    at resolution r blurs its input (B, r, r, C) with pad (2, 2) before the
    stride-2 3x3 conv and with pad (1, 1) before the 1x1 skip; the backward
    runs the same kernel with the flipped taps on the gradients of those
    outputs, (B, r + 1, r + 1, C) with pad (1, 1) and (B, r - 1, r - 1, C)
    with pad (2, 2). The fused act follows conv_in, each block's two convs,
    the final conv and the first linear layer."""
    from ganecdotes_torch.models.stylegan2.generator import channel_map

    cfg = pidray_config(os.path.join(ROOT, "build", "chip_smoke_gan"))
    # as gan/train.py builds the discriminator
    ch = channel_map(getattr(cfg, "chl_multiplier", 2), getattr(cfg, "res2chlmap", None))
    b, size = cfg.batch_size, cfg.image_size
    out = []
    r = size
    while r > 4:
        c = ch[r]
        out += [("upfirdn2d", f"D fwd 3x3 {r}^2x{c}", (b, r, r, c), (2, 2), 1),
                ("upfirdn2d", f"D fwd skip {r}^2x{c}", (b, r, r, c), (1, 1), 1),
                ("upfirdn2d", f"D bwd 3x3 {r}^2x{c}", (b, r + 1, r + 1, c), (1, 1), 1),
                ("upfirdn2d", f"D bwd skip {r}^2x{c}", (b, r - 1, r - 1, c), (2, 2), 1)]
        r //= 2
    r = size
    while r >= 4:  # conv_in / conv1 at r, conv2 into r (final_conv at 4)
        out.append(("fused_leaky_relu", f"D act {r}^2x{ch[r]}", (b, r, r, ch[r]), None, 2))
        r //= 2
    out.append(("fused_leaky_relu", f"D act lin1 {ch[4]}", (b, ch[4]), None, 1))
    return out


def check_fused_act_bwd(x, bias, case, d_calls):
    """The backward kernel (dx and db from g and the saved y) at one of
    D's activations, against the plain backward (_flr_bwd in torch ops):
    dx equal bit for bit, db within KERNEL_TOL and equal over two launches;
    the time of kernel and plain version, and the bytes bound (g and y read,
    dx written, 12 bytes an element). ``calls``: the backward's calls per
    D forward, so the line's row sums one backward of every activation."""
    from ganecdotes_torch.ops import fused_act

    y = fused_act.fused_leaky_relu(x, bias)
    g = torch.randn_like(y)

    def kern():
        return fused_act.fused_leaky_relu_bwd(g, y)

    def plain():
        return fused_act.fused_leaky_relu_bwd_ref(g, y)

    (dx, db), (want_dx, want_db) = kern(), plain()
    torch.cuda.synchronize()
    dx_equal = torch.equal(dx, want_dx)
    err, rel, scale = errors(db, want_db)
    tol = KERNEL_TOL * max(1.0, scale)
    repeat = torch.equal(kern()[1], db)
    moved = nbytes(g, y, dx, db)
    flops = 4 * g.numel()  # compare, select, scale, and db's add
    row = {
        "kernel": "fused_leaky_relu_bwd", "case": case.replace("act", "act bwd"),
        "shape": list(x.shape), "pad": None, "calls": d_calls,
        "calls_per_d_forward": d_calls,
        "max_abs_err": max(err, errors(dx, want_dx)[0]), "max_rel_err": rel,
        "db_max_abs_err": err, "tol": tol, "dx_bit_equal": dx_equal,
        "db_repeats": repeat, "max_abs_err_convT_blur": None,
        "ok": dx_equal and err <= tol and repeat,
        "ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": None,
        "library_err": None, "bytes": moved, "flops": flops,
    }
    row["bound_ms"], row["bound_by"] = bound_ms(moved, [(flops, FP32)])
    print(f"  {'fused_leaky_relu_bwd':18s} {row['case']:26s} {str(tuple(x.shape)):22s} "
          f"dx equal {dx_equal}, db err {err:.3e} (tol {tol:.1e}), repeats {repeat} "
          f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    check(row["ok"], f"fused_leaky_relu_bwd {case}: dx equal {dx_equal}, db err "
                     f"{err} over tolerance {tol} or two launches differ ({repeat})")
    return row


def check_gan_shapes(dev):
    """The blur and the fused act at gan_d_shapes(), each against its plain
    version with the time of kernel, plain version and bytes bound; the
    blur's library call is the depthwise F.conv2d (groups = C). Measured
    only: calls = 0, so no row joins a per-request sum. At each fused act
    shape the backward kernel too (check_fused_act_bwd)."""
    import torch.nn.functional as F

    from ganecdotes_torch.ops import fused_act, upfirdn2d

    gen = torch.Generator(device=dev).manual_seed(2)
    k = upfirdn2d.make_kernel((1, 3, 3, 1))
    wk = torch.as_tensor(k[::-1, ::-1].copy(), device=dev)
    rows = []
    for name, case, shape, pad, d_calls in gan_d_shapes():
        x = torch.randn(*shape, generator=gen, device=dev)
        lib = None
        if name == "upfirdn2d":
            def kern(x=x, pad=pad):
                return upfirdn2d.upfirdn2d(x, k, pad=pad)

            def plain(x=x, pad=pad):
                return upfirdn2d.upfirdn2d_ref(x, k, pad=pad)

            w = wk.expand(shape[3], 1, 4, 4)

            def lib(x=x, w=w, pad=pad):  # the same function in one call
                return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad[0],
                                groups=x.shape[3]).permute(0, 2, 3, 1)

            out_n = shape[0] * (shape[1] + 2 * pad[0] - 3) ** 2 * shape[3]
            moved = nbytes(x) + out_n * 4
            flops = 2 * out_n * 16
        else:
            bias = torch.randn(shape[-1], generator=gen, device=dev)

            def kern(x=x, bias=bias):
                return fused_act.fused_leaky_relu(x, bias)

            def plain(x=x, bias=bias):
                return fused_act.fused_leaky_relu_ref(x, bias)

            moved = nbytes(x, bias, x)
            flops = 3 * x.numel()
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel, scale = errors(got, want)
        tol = KERNEL_TOL * max(1.0, scale)
        row = {
            "kernel": name, "case": case, "shape": list(shape), "pad": pad,
            "calls": 0, "calls_per_d_forward": d_calls,
            "max_abs_err": err, "max_rel_err": rel, "tol": tol,
            "max_abs_err_convT_blur": None, "ok": err <= tol,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": None if lib is None else time_ms(lib),
            "library_err": None if lib is None else errors(lib(), want)[0],
            "bytes": moved, "flops": flops,
        }
        row["bound_ms"], row["bound_by"] = bound_ms(moved, [(flops, FP32)])
        rows.append(row)
        print(f"  {name:18s} {case:26s} {str(tuple(shape)):22s} err {err:.3e} "
              f"(tol {tol:.1e}) ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
              f"lib {row['library_ms'] if lib is None else round(row['library_ms'], 4)} "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        check(row["ok"], f"{name} {case}: max abs err {err} over tolerance {tol}")
        if name == "fused_leaky_relu":
            rows.append(check_fused_act_bwd(x, bias, case, d_calls))
    return rows


def fir_library(k, up, down, pad):
    """One PyTorch call computing upfirdn2d(., k, up, down, pad) on NHWC x,
    for the cases the paths give: a depthwise F.conv_transpose2d (stride up,
    the taps as they are) where an axis upsamples, else a depthwise
    F.conv2d (stride down, the taps flipped) on the image cropped by a
    negative pad. Pads are symmetric per axis where no axis upsamples."""
    import torch.nn.functional as F

    (ux, uy), (dx, dy), (px0, px1, py0, py1) = up, down, pad
    kh, kw = k.shape
    if max(ux, uy) > 1:
        check((dx, dy) == (1, 1), f"no library call for up {up} with down {down}")
        pads = (kh - 1 - py0, kw - 1 - px0)
        out_pad = (py1 - py0 + uy - 1, px1 - px0 + ux - 1)

        def lib(x, w):
            return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=(uy, ux),
                                      padding=pads, output_padding=out_pad,
                                      groups=x.shape[3]).permute(0, 2, 3, 1)
        return lib, torch.as_tensor(k.copy())
    check(px0 == px1 and py0 == py1, f"no library call for the pad {pad}")
    crop_y, crop_x = max(-py0, 0), max(-px0, 0)

    def lib(x, w):
        xn = x.permute(0, 3, 1, 2)[:, :, crop_y:x.shape[1] - crop_y,
                                   crop_x:x.shape[2] - crop_x]
        return F.conv2d(xn, w, stride=(dy, dx), padding=(max(py0, 0), max(px0, 0)),
                        groups=x.shape[3]).permute(0, 2, 3, 1)
    return lib, torch.as_tensor(k[::-1, ::-1].copy())


def gan_fir_shapes():
    """The FIR kernel's other calls in a BagGAN-HQ iteration at the pidray
    config: (case, x shape, 2-D kernel, up, down, pad). ADA's four SYM6
    passes at B = 20 (padded 256^2 image 2x up along x, then y; the warp's
    output 2x down along x, then y); the PPL composite's blur (pad 1, gain
    4) on each up layer's conv_transpose output at the PPL batch; the
    to_rgb upsample's backward, a down-2 FIR of the gradient with the
    flipped taps, at 64^2-256^2."""
    import numpy as np

    from ganecdotes_torch.gan.ada import SYM6, warp_geometry, wavelet_passes
    from ganecdotes_torch.models.stylegan2.generator import channel_map
    from ganecdotes_torch.ops import upfirdn2d as tup

    cfg = pidray_config(os.path.join(ROOT, "build", "chip_smoke_gan"))
    b, size = cfg.batch_size, cfg.image_size
    out = []
    k = np.asarray(SYM6, np.float32)
    # the padded image is half the warp's 2x source; m the warp's output
    _, (src, _), (m, _) = warp_geometry(torch.eye(3)[None], size, size)
    shape = (b, src // 2, src // 2, 3)
    for i, (kern, up, down, pad) in enumerate(wavelet_passes(k)):
        up, down, pad = tup._normalize_args(up, down, pad)
        if i == 2:
            shape = (b, m, m, 3)
        axis = "x" if kern.shape[0] == 1 else "y"
        verb = "up" if max(up) > 1 else "down"
        out.append((f"ADA {verb} {axis}", shape, kern, up, down, pad))
        kh, kw = kern.shape
        shape = (b, tup.out_size(shape[1], up[1], pad[2], pad[3], kh, down[1]),
                 tup.out_size(shape[2], up[0], pad[0], pad[1], kw, down[0]), 3)
    ch = channel_map(getattr(cfg, "chl_multiplier", 2), getattr(cfg, "res2chlmap", None))
    blur = tup.make_kernel((1, 3, 3, 1), gain=4.0)
    ppl_b = max(1, b // cfg.path_batch_shrink)
    r = 8
    while r <= size:
        out.append((f"PPL blur {r}^2x{ch[r]}", (ppl_b, r + 1, r + 1, ch[r]), blur,
                    (1, 1), (1, 1), (1, 1, 1, 1)))
        r *= 2
    flipped = np.ascontiguousarray(blur[::-1, ::-1])
    for r in (64, 128, 256):
        out.append((f"to_rgb bwd {r}^2", (b, r, r, 3), flipped, (1, 1), (2, 2), (1, 1, 1, 1)))
    return out


def check_fir_shapes(dev):
    """The FIR kernel at gan_fir_shapes(), each against its plain version
    with the time of kernel, plain version, one library call and the bytes
    bound. Measured only (calls = 0)."""
    from ganecdotes_torch.ops import upfirdn2d as tup

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for case, shape, k, up, down, pad in gan_fir_shapes():
        x = torch.randn(*shape, generator=gen, device=dev)

        def kern(x=x, k=k, up=up, down=down, pad=pad):
            return tup.upfirdn2d(x, k, up=up, down=down, pad=pad)

        def plain(x=x, k=k, up=up, down=down, pad=pad):
            return tup.upfirdn2d_ref(x, k, up=up, down=down, pad=pad)

        fn, w = fir_library(k, up, down, pad)
        w = w.to(dev).expand(shape[3], 1, *k.shape)

        def lib(x=x, fn=fn, w=w):
            return fn(x, w)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel, scale = errors(got, want)
        tol = KERNEL_TOL * max(1.0, scale)
        check(tuple(got.shape) == tuple(want.shape), f"FIR {case}: shape {tuple(got.shape)}")
        kh, kw = k.shape
        # the separable form's multiply-adds: the vertical taps at each
        # intermediate (output rows x the columns the horizontal taps read),
        # the horizontal taps at each output
        mid_n = want.numel() * down[0]
        flops = 2 * (mid_n * kh / up[1] + want.numel() * kw / up[0])
        row = {
            "kernel": "upfirdn2d", "case": case, "shape": list(shape), "pad": list(pad),
            "up": list(up), "down": list(down), "taps": [kh, kw], "calls": 0,
            "max_abs_err": err, "max_rel_err": rel, "tol": tol,
            "max_abs_err_convT_blur": None, "ok": err <= tol,
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
            "library_err": errors(lib(), want)[0],
            "bytes": nbytes(x, want), "flops": flops,
        }
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], [(flops, FP32)])
        rows.append(row)
        print(f"  upfirdn2d {case:22s} {str(tuple(shape)):22s} err {err:.3e} "
              f"(tol {tol:.1e}) ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
              f"lib {row['library_ms']:.4f} (err {row['library_err']:.1e}) "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        check(row["ok"], f"upfirdn2d {case}: max abs err {err} over tolerance {tol}")
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
        ("K 8000", b, 8000, niters, uniform(b, 8000), 0),  # the generic config's K
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
        code_tol = SINKHORN_CODE_TOL / k_
        # deterministic: the chunks' partials merge in a fixed order
        check(torch.equal(kern(), got), f"sinkhorn {case}: two launches differ")
        # the planted fault: one iteration short, against the full plain run
        fault_err = None
        if n_ > 0:
            short = sinkhorn.sinkhorn_knopp(x, n_ - 1, eps, r, c)
            fault_err = (short - want).abs().max().item()
        moved, flops = sinkhorn_bound(b_, k_, n_)
        row = {
            "kernel": "sinkhorn_knopp", "case": case, "shape": [b_, k_],
            "niters": n_, "eps": eps, "calls": n_calls, "max_abs_err": err,
            "tol": SINKHORN_TOL, "code_tol": code_tol,
            "fault_max_abs_err": fault_err, "max_abs_err_convT_blur": None,
            "max_code": want.max().item(),
            "scores_span_over_eps": ((x.max() - x.min()) / eps).item(),
            "ok": err <= min(SINKHORN_TOL, code_tol) and finite,
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": None,
            "bytes": moved, "flops": flops,
        }
        row["bound_ms"], row["bound_by"] = bound_ms(moved, [(flops, FP32)])
        rows.append(row)
        fault = "" if fault_err is None else f"; niters - 1 err {fault_err:.3e}"
        print(f"  sinkhorn_knopp {case:8s} {str((b_, k_)):14s} niters {n_:2d} "
              f"err {err:.3e} (tol {SINKHORN_TOL:.0e}, {code_tol:.2e} = "
              f"{SINKHORN_CODE_TOL}/K{fault}) ms {row['ms']:.4f} "
              f"plain {row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)
        check(row["ok"], f"sinkhorn {case} {(b_, k_)}: max abs err {err} "
                         f"(finite {finite}) over tolerance {SINKHORN_TOL} "
                         f"or {code_tol}")
        check(fault_err is None or fault_err > code_tol,
              f"sinkhorn {case}: the gate {code_tol} misses a kernel one "
              f"iteration short (max abs err {fault_err})")
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
    unfused = check_folded(server, zs)

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
        "z0_agreement": z0_agree, "profile": prof, "unfused": unfused,
    }


def check_folded(server, zs):
    """The folded request (``serve``: the head's first conv folded into the
    pyramid) against the unfused one (projection, then head) on the same
    requests: the image bit-equal, logits within
    KERNEL_TOL * max(1, max |unfused|), labels on LABEL_AGREEMENT of the
    pixels, sample 0's embedding (z0's) within the logits' tolerance; then
    each form's request ms and peak memory, and one unfused request under
    torch.profiler."""
    logit_err, emb_err, lab_agree, z0_agree = 0.0, 0.0, 1.0, 1.0
    for z in zs:
        img, logits, emb0 = server.infer_folded(z)
        u_img, u_logits, u_emb0 = server.infer(z)
        check(torch.equal(img, u_img), "the folded request's image differs")
        err, _, scale = errors(logits, u_logits)
        logit_err = max(logit_err, err / max(1.0, scale))
        lab_agree = min(lab_agree, (logits.argmax(-1) == u_logits.argmax(-1))
                        .float().mean().item())
        # z0: sample 0 projected alone, against its row of the batch's
        # projection (another GEMM shape, another summation order)
        err, _, scale = errors(emb0, u_emb0)
        emb_err = max(emb_err, err / max(1.0, scale))
        z0_agree = min(z0_agree, (emb0.argmax(-1) == u_emb0.argmax(-1))
                       .float().mean().item())
        del img, logits, emb0, u_img, u_logits, u_emb0
    timing = {}
    for name, fn in (("folded", server.serve), ("unfused", server.serve_unfused)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for z in zs:
            t0 = time.perf_counter()
            fn(z)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timing[name] = {"request_ms": ms, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print(f"  folded vs unfused: logits err {logit_err:.3e}, z0 embedding err "
          f"{emb_err:.3e} (tol {KERNEL_TOL}), label agreement {lab_agree:.6f}, "
          f"z0 agreement {z0_agree:.6f}; request ms folded "
          f"{[round(t, 3) for t in timing['folded']['request_ms']]}, unfused "
          f"{[round(t, 3) for t in timing['unfused']['request_ms']]}; peak memory "
          f"folded {timing['folded']['peak_memory_bytes'] / 2**30:.3f} GiB, unfused "
          f"{timing['unfused']['peak_memory_bytes'] / 2**30:.3f} GiB", flush=True)
    check(logit_err <= KERNEL_TOL, f"folded logits differ from the unfused: {logit_err}")
    check(emb_err <= KERNEL_TOL, f"the z0 embedding differs from the unfused: {emb_err}")
    check(lab_agree >= LABEL_AGREEMENT, f"folded label agreement {lab_agree}")
    check(z0_agree >= LABEL_AGREEMENT, f"folded z0 agreement {z0_agree}")

    prof = profile_request(types.SimpleNamespace(serve=server.serve_unfused), zs[-1])
    print(f"  one unfused request profiled: {json.dumps(prof)}", flush=True)
    return {"logit_err": logit_err, "z0_embedding_err": emb_err,
            "label_agreement": lab_agree, "z0_agreement": z0_agree, **timing,
            "profile": prof, "conv_choice": fold_conv_choice(server.device)}


def fold_conv_choice(dev):
    """The folded request's largest conv, the 64^2 polyphase conv (B = 8,
    512 -> 192 channels), by F.conv2d as cuDNN's heuristic runs it against
    the port's matmul form (``embed._conv3x3``): both within KERNEL_TOL of
    each other, their ms (CUDA events) and peak memory above the inputs."""
    from ganecdotes_torch.nn.layers import conv2d_dilated_nhwc
    from ganecdotes_torch.selfsup.embed import _conv3x3

    g = torch.Generator().manual_seed(5)
    z = torch.randn(B, 64, 64, 512, generator=g).to(dev)
    w = (torch.randn(3, 3, 512, 192, generator=g) * 0.01).to(dev)
    forms = {"F.conv2d": lambda: conv2d_dilated_nhwc(z, w, dilation=1, padding=1),
             "matmul": lambda: _conv3x3(z, w)}
    err, _, scale = errors(forms["matmul"](), forms["F.conv2d"]())
    check(err <= KERNEL_TOL * max(1.0, scale), f"the matmul conv differs: {err}")
    out = {"err": err}
    for name, fn in forms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(fn)
        out[name] = {"ms": ms, "peak_above_inputs_bytes":
                     torch.cuda.max_memory_allocated() - base}
    print(f"  the 64^2 polyphase conv: F.conv2d {out['F.conv2d']['ms']:.4f} ms, "
          f"{out['F.conv2d']['peak_above_inputs_bytes'] / 2**30:.3f} GiB; matmul "
          f"form {out['matmul']['ms']:.4f} ms, "
          f"{out['matmul']['peak_above_inputs_bytes'] / 2**30:.3f} GiB; err {err:.3e}",
          flush=True)
    return out


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
    for k in PRETRAIN_KERNELS:
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


# ---------------------------------------------------------------------------
# phase 6: ADA's warp pass and its adjoint
# ---------------------------------------------------------------------------


def resample_cases(dev):
    """(case, x, alpha, intercept, out_len, calls per augment call) of the
    two passes BagGAN-HQ's augment runs at 256^2, B = 20, with the geometry
    of ADA draws at p = 1 (p = 0 draws the identity), a small ragged case
    with a flip, and small cases at alpha = 0 and 0.05. The images are
    random: the pass does not care."""
    from ganecdotes_torch.gan.ada import sample_transforms, warp_geometry
    from ganecdotes_torch.ops.affine_warp import norm_to_pixel_matrix, shear_geometry
    from ganecdotes_torch.ops.resample import resample_rows_ref

    for seed in range(21, 121):  # the first draw with both branches and a flip
        G, _ = sample_transforms(torch.Generator().manual_seed(seed), 1.0, GAN_B,
                                 GAN_SIZE, GAN_SIZE, dev)
        G_inv, src, out = warp_geometry(G, GAN_SIZE, GAN_SIZE)
        M = norm_to_pixel_matrix(G_inv, src, out)
        swap, delta, icpt_v, a, icpt_h = shear_geometry(M, src[1], out[0])
        if (bool(swap.any()) and not bool(swap.all())
                and bool((delta < 0).any() or (a < 0).any())):
            break
    else:
        raise SmokeFailure("no ADA draw covers both warp branches and a flip")
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(GAN_B, 3, src[0], src[1], generator=gen, device=dev)
    x_eff = torch.where(swap[:, None, None, None], x.transpose(2, 3), x).contiguous()
    at = resample_rows_ref(x_eff, delta, icpt_v, out[0]).transpose(2, 3).contiguous()
    b, s_len, w, v = 3, 101, 77, 59
    ragged = (torch.randn(b, 1, s_len, w, generator=gen, device=dev),
              -(torch.rand(b, generator=gen, device=dev) * 0.6 + 0.7),
              torch.rand(b, w, generator=gen, device=dev) * (s_len + 10) + 0.8 * s_len - 5)
    # alpha = 0 (delta is not clamped) and a small alpha: the adjoint's
    # widest candidate windows
    x_r = torch.randn(b, 1, s_len, w, generator=gen, device=dev)
    icpt_r = torch.rand(b, w, generator=gen, device=dev) * (s_len + 10) - 5
    return [("pass V", x_eff, delta.contiguous(), icpt_v.contiguous(), out[0], 1),
            ("pass H", at, a.contiguous(), icpt_h.contiguous(), out[1], 1),
            ("ragged flip", *ragged, v, 0),
            ("alpha 0", x_r, torch.zeros(b, device=dev), icpt_r, v, 0),
            ("alpha 0.05", x_r, torch.full((b,), 0.05, device=dev), icpt_r, v, 0)]


def _grid_for_pass(alpha, intercept, s_len, out_len):
    """F.grid_sample's grid for a pass along rows: columns stay, rows read
    alpha*v + intercept[w] (normalised, align_corners=False)."""
    b, w = intercept.shape
    dev = intercept.device
    cols = torch.arange(w, device=dev, dtype=torch.float32)
    rows = (alpha[:, None, None] * torch.arange(out_len, device=dev, dtype=torch.float32)[None, :, None]
            + intercept[:, None, :])
    gx = ((2 * cols + 1) / w - 1).expand(b, out_len, w)
    gy = (2 * rows + 1) / s_len - 1
    return torch.stack([gx, gy], dim=-1).contiguous()


def check_resample(dev):
    import torch.nn.functional as F

    from ganecdotes_torch.ops import resample

    rows = []
    for case, x, alpha, icpt, out_len, calls in resample_cases(dev):
        s_len = x.shape[2]
        grid = _grid_for_pass(alpha, icpt, s_len, out_len)
        g = torch.randn(x.shape[0], x.shape[1], out_len, x.shape[3], device=dev)
        specs = {
            "resample_rows": (
                lambda x=x, a=alpha, i=icpt, n=out_len: resample.resample_rows(x, a, i, n),
                lambda x=x, a=alpha, i=icpt, n=out_len: resample.resample_rows_ref(x, a, i, n),
                lambda x=x, grid=grid: F.grid_sample(x, grid, mode="bilinear",
                                                     padding_mode="zeros",
                                                     align_corners=False),
                nbytes(x, alpha, icpt, g)),
            "resample_rows_t": (
                lambda g=g, a=alpha, i=icpt, n=s_len: resample.resample_rows_t(g, a, i, n),
                lambda g=g, a=alpha, i=icpt, n=s_len: resample.resample_rows_t_ref(g, a, i, n),
                lambda g=g, x=x, grid=grid: torch.ops.aten.grid_sampler_2d_backward(
                    g, x, grid, 0, 0, False, [True, False])[0],
                nbytes(g, alpha, icpt, x)),
        }
        outs = {}
        for name, (kern, plain, lib, moved) in specs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, rel, scale = errors(got, want)
            tol = RESAMPLE_TOL * max(1.0, scale)
            lib_err = errors(lib(), want)[0]
            outs[name] = got
            if name == "resample_rows_t":  # deterministic: no atomics
                check(torch.equal(kern(), got), f"{name} {case}: two launches differ")
            row = {
                "kernel": name, "case": case, "shape": list(x.shape), "out_len": out_len,
                "calls": calls, "max_abs_err": err, "max_rel_err": rel, "tol": tol,
                "max_abs_err_convT_blur": None, "library_err": lib_err,
                "ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
                "bytes": moved, "flops": 3 * (g.numel() if name == "resample_rows" else x.numel()),
            }
            row["bound_ms"], row["bound_by"] = bound_ms(
                row["bytes"], [(row["flops"], FP32)])
            row["ok"] = err <= tol
            rows.append(row)
            print(f"  {name:15s} {case:11s} {str(tuple(x.shape)):20s} -> {out_len} "
                  f"err {err:.3e} (tol {tol:.1e}; grid_sample {lib_err:.2e}) "
                  f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
                  f"lib {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
                  f"({row['bound_by']})", flush=True)
            check(row["ok"], f"{name} {case}: max abs err {err} over tolerance {tol}")
        lhs = (outs["resample_rows"].double() * g.double()).sum().item()
        rhs = (x.double() * outs["resample_rows_t"].double()).sum().item()
        bound = ADJOINT_TOL * (outs["resample_rows"].double().norm()
                               * g.double().norm()).item()
        print(f"  adjoint identity {case}: <Ax,g> {lhs:.6e} <x,A^T g> {rhs:.6e} "
              f"diff {abs(lhs - rhs):.3e} (tol {bound:.3e})", flush=True)
        rows[-1]["adjoint_diff"] = abs(lhs - rhs)
        check(abs(lhs - rhs) <= bound, f"adjoint identity fails on {case}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: BagGAN-HQ training
# ---------------------------------------------------------------------------

GAN_PROFILE_LABELS = ("gan.d_step", "gan.r1", "gan.g_step", "gan.ppl", "gan.ada")
# the cuDNN kernel that ran the plain FIRs' depthwise convs, twice
# differentiated in gan.r1 and gan.ppl; it runs ungrouped convs too, so the
# evidence that no plain FIR runs is the grouped F.conv2d count
# (grouped_convs_per_step), and its device time is only reported
IMPLICIT_GEMM_INDEXED = "implicit_gemm_indexed"
# kernel-name fragments of the elementwise passes: the fused act's forward
# and backward kernels (csrc/fused_act.cu), PyTorch's elementwise kernels
# and its reductions (where a torch-op backward of the fused act would run)
ELEMENTWISE_TAGS = {"fused_act": "fused_leaky_relu", "torch_elementwise": "elementwise_kernel",
                    "torch_reduce": "reduce_kernel"}


def pidray_config(out_dir):
    """The port's copy of the pidray config, with its outputs under out_dir
    and no log file."""
    from ganecdotes_torch.configs.models.baggan import config_pidray_unlabeled as pc

    cfg = {k: v for k, v in vars(pc).items()
           if not k.startswith("_") and not isinstance(v, types.ModuleType)}
    cfg.update(out_dir=out_dir, checkpoint_dir=out_dir, training_log_path=None)
    return types.SimpleNamespace(**cfg)


def gan_losses(gan, it):
    cfg = gan.config
    keys = ["d", "d_out", "d_ref", "g_gan"]
    if it % cfg.d_reg_every == 0:
        keys.append("d_r1")
    if it % cfg.g_reg_every == 0:
        keys.append("g_ppl")
    return {k: float(getattr(gan, "loss_" + k)) for k in keys}


@contextmanager
def grouped_convs_per_step(gan):
    """Count the grouped (depthwise) F.conv2d calls on CUDA tensors in each
    of ``gan``'s step kinds while the block runs: the plain FIR is one, and
    the FIR kernel makes none. Yields {step kind: count}."""
    import torch.nn.functional as F

    from ganecdotes_torch.gan.train import STEP_KINDS

    counts = dict.fromkeys(STEP_KINDS + ("outside",), 0)
    kind = ["outside"]
    conv2d, step = F.conv2d, gan._step

    def counting(*args, **kwargs):
        groups = kwargs.get("groups", args[6] if len(args) > 6 else 1)
        if groups > 1 and args[0].is_cuda:
            counts[kind[0]] += 1
        return conv2d(*args, **kwargs)

    @contextmanager
    def tagged(k):
        kind[0] = k
        try:
            with step(k):
                yield
        finally:
            kind[0] = "outside"

    F.conv2d, gan._step = counting, tagged
    try:
        yield counts
    finally:
        F.conv2d = conv2d
        del gan._step


def run_gan(dev, ops):
    """BagGANHQ at the full pidray config for GAN_ITERS iterations from seed
    0; the trainer, per-iteration host ms, losses and the grouped convs on
    the card per step kind."""
    from ganecdotes_torch.gan.train import BagGANHQ

    cfg = pidray_config(os.path.join(ROOT, "build", "chip_smoke_gan"))
    gan = BagGANHQ(cfg, seed=0, device=dev, ops=ops)
    gan.ada_state["p"].fill_(ADA_P)
    gan.time_steps = True
    gan.keep_first_grads = True
    gen = torch.Generator(device=dev).manual_seed(11)
    size = cfg.image_size
    iter_ms, losses = [], []
    with grouped_convs_per_step(gan) as grouped:
        for it in range(GAN_ITERS):
            real = torch.rand(cfg.batch_size, size, size, cfg.num_channels,
                              generator=gen, device=dev) * 2 - 1
            gan.set_input(real, iter_no=it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gan.optimize_parameters()
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(gan_losses(gan, it))
    gan.grouped_convs = grouped
    return gan, iter_ms, losses


def profile_iteration(gan):
    """Device time of one KERNELS iteration with all four step kinds
    (iter_no 0) under torch.profiler, split by the record_function ranges:
    each kernel counts toward the innermost range whose device-side span it
    starts in (gan.ada lies inside the steps); kernels outside every range
    make up "outside"."""
    from torch.profiler import ProfilerActivity, profile

    gan.time_steps = False
    gan.set_input(gan.ref_image, iter_no=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gan.optimize_parameters()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in device
             if e.name in GAN_PROFILE_LABELS]
    kernels = [e for e in device if e.name not in GAN_PROFILE_LABELS]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    split = {label: 0.0 for label in GAN_PROFILE_LABELS}
    span_ms = {label: 0.0 for label in GAN_PROFILE_LABELS}
    in_range = {label: {} for label in GAN_PROFILE_LABELS}  # kernel name -> ms
    for label, a, b in spans:
        span_ms[label] += (b - a) / 1e3
    for e in kernels:
        inside = [(b - a, lb) for lb, a, b in spans if a <= e.time_range.start < b]
        if inside:
            label, ms = min(inside)[1], e.time_range.elapsed_us() / 1e3
            split[label] += ms
            in_range[label][e.name] = in_range[label].get(e.name, 0.0) + ms
    split["outside"] = busy - sum(split.values())
    top_by_range = {
        label: [{"name": k[:90], "ms": ms}
                for k, ms in sorted(names.items(), key=lambda kv: -kv[1])[:5]]
        for label, names in in_range.items()}
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    resample_ms = sum(ms for k, (_, ms) in by_name.items() if "resample_rows" in k)
    # per range, the FIR kernel's device time and IMPLICIT_GEMM_INDEXED's
    fir_ms = {label: sum(ms for k, ms in names.items() if "upfirdn2d_kernel" in k)
              for label, names in in_range.items()}
    indexed_ms = {label: sum(ms for k, ms in names.items() if IMPLICIT_GEMM_INDEXED in k)
                  for label, names in in_range.items()}
    # per range, the elementwise passes' device time: the fused act's two
    # kernels, PyTorch's elementwise kernels and its reductions
    elementwise_ms = {label: {kind: sum(ms for k, ms in names.items() if tag in k)
                              for kind, tag in ELEMENTWISE_TAGS.items()}
                      for label, names in in_range.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
        "split_ms": split, "span_ms": span_ms, "resample_kernels_ms": resample_ms,
        "fir_kernel_ms": fir_ms, "implicit_gemm_indexed_ms": indexed_ms,
        "elementwise_ms": elementwise_ms,
        "top": [{"name": k[:90], "ms": ms, "count": n} for k, (n, ms) in top],
        "top_by_range": top_by_range,
    }


def _tensor_names(gan, kind):
    if kind in ("d", "r1"):
        return [n for n, _ in gan.netD.named_parameters()]
    return ([n for n, _ in gan.netG.named_parameters()]
            + [f"noises.{i}" for i in range(len(gan.netG.noises))])


def check_gan_agreement(kern, plain):
    """The KERNELS run against the PLAIN run from the same seed (same
    weights, batches and draws): iteration 0's gradients of each step kind,
    tensor by tensor, within GAN_GRAD_TOL of the norm of that step's whole
    gradient; the first D loss within GAN_LOSS_TOL and every later loss
    within GAN_DRIFT_TOL, relative to max(1, |plain|); the params after the
    run only reported.

    Both runs are float32 with TF32 off; the kernels sum in other orders
    than cuDNN and the plain passes. The D step's gradients come from equal
    weights and differ by rounding, amplified through the WGAN-GP gradient
    of a gradient (4.2e-4 of the norm on an NVIDIA H100 80GB HBM3 at 700 W).
    Adam's first step with beta1 = 0 moves each parameter by about
    lr * sign(g), so a gradient element within rounding of zero moves its
    parameter by up to 2 lr the other way: R1, G and PPL see weights that
    differ by that after 1, 2 and 3 updates (their gradients differed by
    2.6e-3, 1.2e-3 and 6.1e-3 of the norm; no tensor more than 1.5e-3),
    every loss after the first update drifts (1.9e-3 to 2.3e-3 relative
    over 5 iterations in three runs: cuDNN's reductions are not bitwise
    repeatable), and the params are compared only as a reported number.
    The gradient tolerances leave 5x and more over those readings, the
    drift tolerance about 9x; a kernel that computes something
    else (a wrong tap, padding or mask) moves a gradient by its own size.
    """
    (k_gan, _, k_losses), (p_gan, _, p_losses) = kern, plain
    grads = {}
    for kind, gs in k_gan.first_grads.items():
        ps = p_gan.first_grads[kind]
        norm = sum(float(p.square().sum()) for p in ps) ** 0.5
        errs = [(float((g - p).norm()) / max(norm, 1e-30), name)
                for g, p, name in zip(gs, ps, _tensor_names(k_gan, kind))]
        diff = sum(float((g - p).square().sum()) for g, p in zip(gs, ps)) ** 0.5
        worst, name = max(errs)
        grads[kind] = {"rel_l2": diff / max(norm, 1e-30), "worst_tensor": name,
                       "worst_tensor_err": worst, "tol": GAN_GRAD_TOL[kind]}
        check(worst <= GAN_GRAD_TOL[kind],
              f"{kind} gradients differ from the plain run: {grads[kind]}")
    loss_errs = [{k: abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in b}
                 for a, b in zip(k_losses, p_losses)]
    first = loss_errs[0]["d"]
    drift = max(v for errs in loss_errs for v in errs.values())
    check(first <= GAN_LOSS_TOL, f"the first D loss differs from the plain run: {first}")
    check(drift <= GAN_DRIFT_TOL, f"losses drift from the plain run: {loss_errs}")
    with torch.no_grad():
        param_err = max(float((a - b).abs().max())
                        for net in ("netG", "netD")
                        for a, b in zip(getattr(k_gan, net).parameters(),
                                        getattr(p_gan, net).parameters()))
    return {"grads": grads, "first_loss_rel_err": first, "loss_max_rel_drift": drift,
            "loss_rel_errs": loss_errs, "param_max_abs_diff": param_err}


def train(dev):
    from ganecdotes_torch.gan.train import STEP_KINDS
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import KERNELS, PLAIN

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    kern = run_gan(dev, KERNELS)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gan, iter_ms, losses = kern
    step_ms = {k: statistics.median(v) for k, v in gan.step_ms.items() if v}
    dg_ms = statistics.median(iter_ms[1:4])
    print(f"  {GAN_ITERS} iterations, ms {[round(t, 3) for t in iter_ms]} (iteration 0: "
          f"D + R1 + G + PPL and warm-up; 1-3: D + G; 4: D + G + PPL); D + G iteration "
          f"median {dg_ms:.3f} ms; ms per step kind (median) "
          f"{ {k: round(v, 3) for k, v in step_ms.items()} }; peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches {launches}", flush=True)
    for kind in STEP_KINDS:
        print(f"  launches in {kind} steps: {gan.step_launches[kind]}", flush=True)
    print(f"  grouped F.conv2d calls on the card per step kind: {gan.grouped_convs}",
          flush=True)
    print(f"  losses {json.dumps(losses)}", flush=True)
    for k in SERVING_KERNELS + RESAMPLE_KERNELS + ("fused_leaky_relu_bwd",):
        check(launches[k] > 0, f"kernel {k} was not launched on the training path")
    # every step kind differentiates D's or G's activations: the backward
    # kernel in each, and in R1's double backward the forward kernel again
    for kind in STEP_KINDS:
        check(gan.step_launches[kind]["fused_leaky_relu_bwd"] > 0,
              f"the fused act's backward kernel did not run in the {kind} steps")
    check(not any(gan.grouped_convs.values()),
          f"a plain FIR (grouped conv) ran on the card: {gan.grouped_convs}")
    # R1 ran once (iteration 0), PPL twice (0 and 4): each FIR's forward
    # and backward launch the kernel (more in a double backward). R1: D's
    # blurs (4 launches a blur, as before) and ADA's four passes; PPL: the
    # to_rgb skip upsamples and the composite's blur at each up layer.
    n_res = gan.config.image_size.bit_length() - 3  # resolutions 8 .. size
    d_blurs = 2 * n_res  # per D forward: before each ResBlock's two convs
    fir = {k: gan.step_launches[k]["upfirdn2d"] for k in STEP_KINDS}
    check(fir["r1"] >= 4 * d_blurs + 2 * 4,
          f"R1 launched the FIR kernel {fir['r1']} times: not D's blurs and ADA's passes")
    check(fir["ppl"] >= 2 * (n_res + n_res),
          f"PPL launched the FIR kernel {fir['ppl']} times: not the to_rgb "
          "upsamples and the composite's blurs")
    check(all(math.isfinite(v) for l in losses for v in l.values()), "non-finite loss")
    # iteration 0's gradients leave the card before the plain run
    gan.first_grads = {k: [g.cpu() for g in v] for k, v in gan.first_grads.items()}
    _build.reset_launches()
    plain = run_gan(dev, PLAIN)
    check(all(v == 0 for v in _build.LAUNCHES.values()), "the plain run launched a kernel")
    print(f"  plain ops: grouped F.conv2d calls on the card per step kind: "
          f"{plain[0].grouped_convs}", flush=True)
    plain[0].first_grads = {k: [g.cpu() for g in v] for k, v in plain[0].first_grads.items()}
    agreement = check_gan_agreement(kern, plain)
    print(f"  plain ops: iteration ms {[round(t, 3) for t in plain[1]]}; ms per step kind "
          f"{ {k: round(statistics.median(v), 3) for k, v in plain[0].step_ms.items() if v} }; "
          f"{json.dumps(agreement)}", flush=True)
    plain_iter_ms, plain_step_ms, plain_losses = plain[1], plain[0].step_ms, plain[2]
    plain_grouped = plain[0].grouped_convs
    del plain
    img = gan.test()
    check(tuple(img.shape) == (GAN_B, GAN_SIZE, GAN_SIZE, 3)
          and bool(torch.isfinite(img).all()),
          "sample image")
    prof = profile_iteration(gan)
    print(f"  one iteration (D + R1 + G + PPL) under torch.profiler: {json.dumps(prof)}",
          flush=True)
    return {
        "iterations": GAN_ITERS, "iter_ms": iter_ms, "dg_iter_ms": dg_ms,
        "step_ms": gan.step_ms, "step_ms_median": step_ms, "peak_memory_bytes": peak,
        "launches": launches, "step_launches": gan.step_launches, "losses": losses,
        "grouped_convs": gan.grouped_convs, "plain_grouped_convs": plain_grouped,
        "plain_iter_ms": plain_iter_ms, "plain_step_ms": plain_step_ms,
        "plain_losses": plain_losses, "agreement": agreement, "profile": prof,
    }


# ---------------------------------------------------------------------------
# phase 8: the evaluate path (setup, one-shot fine-tune, test and scoring)
# ---------------------------------------------------------------------------

EVAL_TEST_SAMPLES = 16  # + the one-shot sample: 2 requests of 8
FEATURE_TOL = IMAGE_TOL  # one-shot features, KERNELS vs PLAIN, the image gate
FIRST_CHUNK_LOSS_RTOL = 1e-3  # the fine-tune loss after its first chunk
LAST_LOSS_RTOL = GAN_DRIFT_TOL  # after all 200 epochs, the GAN's later-loss gate
IOU_TOL = 1e-2  # mean mask IoU, absolute


def _sync_ms(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_evaluate(gen, dev, ops, out_dir):
    """``cli/evaluate.py``'s run at ffhq-256 (hfc_with_swav_ffhq, the
    supervised trainer's 200 epochs, train_hfc False: swav_params.npz is
    loaded), its blocks timed one by one on the host clock (synced), with
    each block's peak memory: set-up, the SwAV preprocessor's set-up, the
    one-shot features, the fine-tune, prediction (and the same requests
    unfused), scoring."""
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

    ms, peak = {}, {}

    def block(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        ms[name] = _sync_ms(t0)
        peak[name] = torch.cuda.max_memory_allocated()
        return out

    _build.reset_launches()
    pipe = block("construct", lambda: OneShotPipeline(
        out_dir, model="ffhq-256", segmentor="hfc_with_swav_ffhq",
        num_test_samples=EVAL_TEST_SAMPLES, device=dev, ops=ops, gen=gen))
    pipe.logger.setLevel(logging.WARNING)  # its per-chunk lines: details only
    pipe.seg_config.train_hfc = False  # evaluate.py's settings
    pipe.seg_config.hfc_prep_args["train"] = False
    block("setup", pipe.setup)
    pipe.preprocessor = block("swav_setup", pipe._build_ssl_preprocessor)
    check(pipe.preprocessor.ssl_params is not None,
          "swav_params.npz was not loaded")
    feats = block("one_shot_features", pipe._extract_one_shot_features)
    block("train", pipe.run_trainer)
    check(pipe.preprocessor.pretrain_count == 0, "the evaluate run pretrained")
    block("predict", pipe.predict_tests)
    launches = dict(_build.LAUNCHES)
    lat = [torch.as_tensor(pipe.test_latents[i : i + B])
           for i in range(0, EVAL_TEST_SAMPLES, B)]
    unfused_ms = []
    for z in lat:
        t0 = time.perf_counter()
        pipe.server.serve_unfused(z, input_is_latent=True)
        unfused_ms.append(_sync_ms(t0))
    t0 = time.perf_counter()
    pipe.score_tests()
    ms["score"] = (time.perf_counter() - t0) * 1e3
    epochs = [(e1 - e0, sec) for (e0, _, _), (e1, _, sec)
              in zip([(0, 0, 0)] + pipe.finetune_log, pipe.finetune_log)]
    return pipe, {
        "block_ms": ms, "peak_memory_bytes": peak, "launches": launches,
        "one_shot_features_shape": list(feats.shape),
        "finetune_losses": [(e, loss) for e, loss, _ in pipe.finetune_log],
        "epoch_ms": [sec * 1e3 / n for n, sec in epochs],
        "finetune_wall_ms": sum(sec for _, _, sec in pipe.finetune_log) * 1e3,
        "request_ms": [t * 1e3 for t in pipe.inference_times],
        "unfused_request_ms": unfused_ms,
        "score_ms_per_image": ms["score"] / pipe.num_test_samples,
        "mean_mask_iou": pipe.mean_mask_iou,
    }


def profile_finetune(pipe, epochs=10):
    """Device-busy share of ``epochs`` fine-tune epochs (torch.profiler),
    from a copy of the trained head on the pipeline's features and label."""
    from torch.profiler import ProfilerActivity, profile

    from ganecdotes_torch.pipeline import losses
    from ganecdotes_torch.pipeline.trainer import make_supervised_finetune
    from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply

    size = pipe.seg_size
    optimizer, run_chunk = make_supervised_finetune(
        lambda p, st, x: (one_shot_segmentor_apply(p, x, size), st),
        [(1.0, losses.cross_entropy)], pipe.model_config.image_size, 1e-3)
    params = [{k: v.detach().clone() for k, v in layer.items()}
              for layer in pipe.segmentor_params]
    opt = optimizer.init(params)
    feats, label = pipe.one_shot_train_features, pipe.one_shot_label
    run_chunk(params, opt, (), feats, label, 0, 2)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, loss = run_chunk(params, opt, (), feats, label, 2, epochs)
        float(loss)
        wall = _sync_ms(t0)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"epochs": epochs, "wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall,
            "top": [{"name": k[:90], "ms": t, "count": n} for k, (n, t) in top]}


def evaluate(dev):
    import shutil

    import numpy as np

    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.ops.opset import KERNELS, PLAIN

    mc, _, _, _ = swav_configs()
    # phase 5's generator (the same seed), so phase 5's swav_params.npz
    # describes its features
    gen = Generator(**mc.gen_args, generator=torch.Generator().manual_seed(0)).to(dev)
    params = os.path.join(ROOT, "build", "chip_smoke_swav", "swav_params.npz")
    runs = {}
    for name, ops in (("kernels", KERNELS), ("plain", PLAIN)):
        out_dir = os.path.join(ROOT, "build", "chip_smoke_eval", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        shutil.copy(params, out_dir)
        runs[name] = run_evaluate(gen, dev, ops, out_dir)
        r = runs[name][1]
        print(f"  {name}: block ms {json.dumps({k: round(v, 3) for k, v in r['block_ms'].items()})}; "
              f"fine-tune median {statistics.median(r['epoch_ms']):.3f} ms an epoch, "
              f"{r['finetune_wall_ms']:.3f} ms for {r['finetune_losses'][-1][0]}; "
              f"request ms folded "
              f"{[round(t, 3) for t in r['request_ms']]}, unfused "
              f"{[round(t, 3) for t in r['unfused_request_ms']]}; scoring "
              f"{r['score_ms_per_image']:.3f} host ms an image; mean mask IoU "
              f"{r['mean_mask_iou']:.6f}; peak GiB "
              f"{json.dumps({k: round(v / 2**30, 3) for k, v in r['peak_memory_bytes'].items()})}",
              flush=True)
    kern, kr = runs["kernels"]
    plain, pr = runs["plain"]
    for k in SERVING_KERNELS:
        check(kr["launches"][k] > 0, f"kernel {k} was not launched on the evaluate path")
    check(all(v == 0 for v in pr["launches"].values()),
          f"the plain run launched kernels: {pr['launches']}")
    kern_prof = profile_finetune(kern)
    print(f"  10 fine-tune epochs under torch.profiler: {json.dumps(kern_prof)}",
          flush=True)

    preds = kern.pred_labels
    check(preds.shape == (EVAL_TEST_SAMPLES, mc.image_size, mc.image_size),
          f"labels shape {preds.shape}")
    check(bool(np.isfinite(kern.test_images).all()), "non-finite test images")
    check(0.0 <= kern.mean_mask_iou <= 1.0, f"mean mask IoU {kern.mean_mask_iou}")
    feat_err, _, feat_scale = errors(kern.one_shot_train_features,
                                     plain.one_shot_train_features)
    feat_err /= max(1.0, feat_scale)
    (e1, k1), (_, kl) = kr["finetune_losses"][0], kr["finetune_losses"][-1]
    (_, p1), (_, pl) = pr["finetune_losses"][0], pr["finetune_losses"][-1]
    first_rel = abs(k1 - p1) / max(abs(p1), 1e-30)
    last_rel = abs(kl - pl) / max(abs(pl), 1e-30)
    agree = float((kern.pred_labels == plain.pred_labels).mean())
    iou_err = abs(kern.mean_mask_iou - plain.mean_mask_iou)
    gates = {"feature_err": feat_err, "first_chunk_loss_rel": first_rel,
             "last_loss_rel": last_rel, "label_agreement": agree,
             "mean_mask_iou_err": iou_err}
    print(f"  kernels vs plain: {json.dumps(gates)} (tols {FEATURE_TOL}, "
          f"{FIRST_CHUNK_LOSS_RTOL}, {LAST_LOSS_RTOL}, >= {LABEL_AGREEMENT}, "
          f"{IOU_TOL}); losses after epoch {e1}: {k1} / {p1}, after "
          f"{kr['finetune_losses'][-1][0]}: {kl} / {pl}", flush=True)
    check(feat_err <= FEATURE_TOL, f"one-shot features differ: {feat_err}")
    check(first_rel <= FIRST_CHUNK_LOSS_RTOL, f"first-chunk loss differs: {first_rel}")
    check(last_rel <= LAST_LOSS_RTOL, f"last loss differs: {last_rel}")
    check(agree >= LABEL_AGREEMENT, f"test label agreement {agree}")
    check(iou_err <= IOU_TOL, f"mean mask IoU differs: {iou_err}")
    check(kl < k1, f"the fine-tune did not lower its loss: {k1} -> {kl}")
    return {"kernels": kr, "plain": pr, "gates": gates, "finetune_profile": kern_prof}


# ---------------------------------------------------------------------------
# phase 9: the other four methods (pretrain where they do, then evaluate)
# ---------------------------------------------------------------------------

METHODS = ("repurposegan", "datasetgan", "hfc_with_simclr", "hfc_kmeans")
PRETRAINED = {"hfc_with_simclr": ["simclr_params.npz"],
              "hfc_kmeans": [f"clusterer_layer_{n}.npz" for n in range(5)]
              + ["model_stats.npz"]}
SIMCLR_STEPS = 5  # of the shipped config's num_iters = 100
CENTER_TOL = 1e-3  # k-means centers, KERNELS vs PLAIN, of max(1, max |plain|)
TIMED_REQUESTS = 3  # folded and unfused, after prediction; median of 2-3


class _Blocks:
    """Host-clock ms (synced), peak device memory and kernel launches of
    named blocks."""

    def __init__(self):
        self.ms, self.peak, self.launches = {}, {}, {}

    def __call__(self, name, fn):
        from ganecdotes_torch.ops import _build

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        self.ms[name] = _sync_ms(t0)
        self.peak[name] = torch.cuda.max_memory_allocated()
        self.launches[name] = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                               if v != before[k]}
        return out


def _method_pipeline(method, out_dir, dev, ops, gen, pretraining,
                     model="ffhq-256", custom=None):
    """OneShotPipeline for ``method`` at ``model`` (ffhq-256; ``custom``
    configs as the pipeline takes them) with cli/pretrain.py's settings
    (``pretraining``; SimCLR cut to SIMCLR_STEPS steps) or
    cli/evaluate.py's. ``gen`` None: the model config's generator."""
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

    pipe = OneShotPipeline(out_dir, model=model, segmentor=method,
                           num_test_samples=EVAL_TEST_SAMPLES, device=dev,
                           ops=ops, gen=gen, custom=custom)
    pipe.logger.setLevel(logging.WARNING)  # its per-chunk lines: details only
    sc = pipe.seg_config
    if method in PRETRAINED or "hfc_with_swav" in method:
        sc.train_hfc = pretraining
        sc.hfc_prep_args["train"] = pretraining
    if method == "hfc_kmeans":
        sc.hfc_prep_args["hfc_args"]["base_args"]["presaved"] = not pretraining
    if method == "hfc_with_simclr" and pretraining:
        sc.hfc_prep_args["simclr_args"]["num_iters"] = SIMCLR_STEPS
    return pipe


def run_method_pretrain(method, gen, dev, ops, out_dir, replay=None):
    """cli/pretrain.py's path up to the fitted preprocessor: SimCLR's steps
    (each step's loss and host ms; ``pretrain`` = the pipeline's one-shot
    features block, which pretrains), or the k-means fit's features
    (``block_features``) and the fit (``fit``: ``HFCPreprocessor.
    train_hfc_model`` in two blocks). ``replay`` = (k-means++ picks, block
    features) of the kernels run: the plain run computes its own block
    features, then fits on the kernels run's with the same picks (Lloyd's
    300 iterations carry a rounding step of their input further than the
    centers' gate, ``method_rounding.py``). Returns (pipeline, record, the
    block features)."""
    blocks = _Blocks()
    pipe = blocks("construct", lambda: _method_pipeline(method, out_dir, dev,
                                                        ops, gen, True))
    blocks("setup", pipe.setup)
    rec = {"block_ms": blocks.ms, "peak_memory_bytes": blocks.peak}
    pre, hidden = pipe.preprocessor, None
    if method == "hfc_with_simclr":
        pipe.preprocessor = pre = blocks("simclr_setup", pipe._build_ssl_preprocessor)
        pre.record_loss_history = True
        blocks("pretrain", pipe._extract_one_shot_features)
        check(pre.pretrain_count == 1 and len(pre.loss_history) == SIMCLR_STEPS,
              "SimCLR did not take its steps")
        rec.update(losses=pre.loss_history,
                   step_ms=[t * 1e3 for t in pre.step_seconds])
    else:
        hidden = blocks("block_features",
                        lambda: pre.block_features(pipe.one_shot_latent))
        fit_on = hidden
        if replay is not None:
            pre.hfc_model.replay_seeds, fit_on = replay
        blocks("fit", lambda: pre.hfc_model.fit(fit_on))
        rec["fit_s"] = blocks.ms["fit"] / 1e3
    for f in PRETRAINED[method]:
        check(os.path.exists(os.path.join(out_dir, f)), f"{f} was not written")
    return pipe, rec, hidden


def run_method_evaluate(method, gen, dev, ops, out_dir, replay_features=None,
                        model="ffhq-256", custom=None):
    """cli/evaluate.py's path for ``method`` at ``model`` (the preprocessor's
    files loaded, not refitted), block by block; then TIMED_REQUESTS folded
    and unfused requests, and scoring. With ``replay_features`` (the kernels
    run's one-shot features) the run computes its own, then fine-tunes on
    those: 200 epochs of Adam carry a rounding step of the features further
    than the loss and label gates (``method_rounding.py``). Returns
    (pipeline, record, its own one-shot features)."""
    from ganecdotes_torch.ops import _build

    blocks = _Blocks()
    pipe = blocks("construct", lambda: _method_pipeline(
        method, out_dir, dev, ops, gen, False, model, custom))
    blocks("setup", pipe.setup)
    if method == "hfc_with_simclr":
        pipe.preprocessor = blocks("simclr_setup", pipe._build_ssl_preprocessor)
        check(pipe.preprocessor.params is not None,
              "simclr_params.npz was not loaded")
    elif "hfc_with_swav" in method:
        pipe.preprocessor = blocks("swav_setup", pipe._build_ssl_preprocessor)
        check(pipe.preprocessor.ssl_params is not None,
              "the SwAV params were not loaded")
    feats = blocks("one_shot_features", pipe._extract_one_shot_features)
    if replay_features is not None:
        pipe._extract_one_shot_features = lambda: replay_features
    blocks("train", pipe.run_trainer)
    if method == "hfc_with_simclr" or "hfc_with_swav" in method:
        check(pipe.preprocessor.pretrain_count == 0, "the evaluate run pretrained")
    blocks("predict", pipe.predict_tests)
    launches = dict(_build.LAUNCHES)
    lat = [torch.as_tensor(pipe.test_latents[i : i + B])
           for i in (0, B, 0)[:TIMED_REQUESTS]]
    req = {}
    for name, fn in (("folded", pipe.server.serve),
                     ("unfused", pipe.server.serve_unfused)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for z in lat:
            t0 = time.perf_counter()
            fn(z, input_is_latent=True)
            ms.append(_sync_ms(t0))
        steady = statistics.median(ms[1:])
        req[name] = {"request_ms": ms, "steady_ms": steady,
                     "img_per_s": B / steady * 1e3,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    t0 = time.perf_counter()
    pipe.score_tests()
    blocks.ms["score"] = (time.perf_counter() - t0) * 1e3
    epochs = [(e1 - e0, sec) for (e0, _, _), (e1, _, sec)
              in zip([(0, 0, 0)] + pipe.finetune_log, pipe.finetune_log)]
    return pipe, {
        "block_ms": blocks.ms, "peak_memory_bytes": blocks.peak,
        "block_launches": blocks.launches,
        "launches": launches, "one_shot_features_shape": list(feats.shape),
        "finetune_conv": pipe.finetune_conv,
        "finetune_losses": [(e, loss) for e, loss, _ in pipe.finetune_log],
        "epoch_ms": [sec * 1e3 / n for n, sec in epochs],
        "finetune_wall_ms": sum(sec for _, _, sec in pipe.finetune_log) * 1e3,
        "predict_request_ms": [t * 1e3 for t in pipe.inference_times],
        "requests": req, "score_ms_per_image": blocks.ms["score"] / pipe.num_test_samples,
        "mean_mask_iou": pipe.mean_mask_iou,
    }, feats


def check_method_folded(pipe):
    """One request (the first B test latents) folded against its unfused
    oracle: the image bit-equal, logits within KERNEL_TOL * max(1, max
    |unfused|), labels on LABEL_AGREEMENT of the pixels; SimCLR's z0
    embedding within the logits' tolerance."""
    z = torch.as_tensor(pipe.test_latents[:B])
    img, logits, emb0 = pipe.server.infer_folded(z, input_is_latent=True)
    u_img, u_logits, u_emb0 = pipe.server.infer(z, input_is_latent=True)
    check(torch.equal(img, u_img), "the folded request's image differs")
    err, _, scale = errors(logits, u_logits)
    out = {"logit_err": err / max(1.0, scale),
           "label_agreement": (logits.argmax(-1) == u_logits.argmax(-1))
           .float().mean().item()}
    if emb0 is not None:
        err, _, scale = errors(emb0, u_emb0)
        out["z0_embedding_err"] = err / max(1.0, scale)
    check(out["logit_err"] <= KERNEL_TOL, f"folded logits differ: {out}")
    check(out.get("z0_embedding_err", 0.0) <= KERNEL_TOL, f"z0 differs: {out}")
    check(out["label_agreement"] >= LABEL_AGREEMENT, f"folded labels: {out}")
    return out


def finetune_conv_choice(pipe, epochs=10):
    """The fine-tune's epoch with the head's first conv by F.conv2d (cuDNN)
    and by the matmul form (``embed._conv3x3``), from a copy of the trained
    head on the pipeline's features: ms an epoch, peak memory, the last
    loss of each."""
    from ganecdotes_torch.pipeline import losses
    from ganecdotes_torch.pipeline.trainer import make_supervised_finetune
    from ganecdotes_torch.selfsup.embed import _conv3x3
    from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply

    size, out = pipe.seg_size, {}
    feats, label = pipe.one_shot_train_features, pipe.one_shot_label
    for name, fc in (("cudnn", None), ("matmul", _conv3x3)):
        optimizer, run_chunk = make_supervised_finetune(
            lambda p, st, x, fc=fc: (one_shot_segmentor_apply(p, x, size, fc), st),
            [(1.0, losses.cross_entropy)], pipe.model_config.image_size, 1e-3)
        params = [{k: v.detach().clone() for k, v in layer.items()}
                  for layer in pipe.segmentor_params]
        opt = optimizer.init(params)
        run_chunk(params, opt, (), feats, label, 0, 2)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, _, loss = run_chunk(params, opt, (), feats, label, 2, epochs)
        out[name] = {"ms_per_epoch": _sync_ms(t0) / epochs, "loss": float(loss),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    rel = abs(out["cudnn"]["loss"] - out["matmul"]["loss"]) / abs(out["cudnn"]["loss"])
    check(rel <= FIRST_CHUNK_LOSS_RTOL, f"the two conv forms' losses differ: {out}")
    return out


def methods(dev):
    """Phase 9: each of the four methods at ffhq-256, with KERNELS and with
    PLAIN: the pretraining (SimCLR, k-means) held run against run, then the
    evaluate path of both runs on the kernels run's pretrained files, held
    against each other with phase 8's gates, and the kernels run's folded
    request against its unfused oracle. Where a later stage would carry
    float32 rounding past its gate (the k-means fit, the fine-tune), the
    plain run gates its own input to the stage and replays the kernels
    run's input through it."""
    import shutil

    import numpy as np

    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import KERNELS, PLAIN

    mc, _, _, _ = swav_configs()
    gen = Generator(**mc.gen_args, generator=torch.Generator().manual_seed(0)).to(dev)
    root = os.path.join(ROOT, "build", "chip_smoke_methods")
    shutil.rmtree(root, ignore_errors=True)
    out, failed = {}, []

    def gate(cond, msg):  # every method runs; the phase fails at its end
        if not cond:
            failed.append(msg)

    for method in METHODS:
        rec = {"pretrain": {}, "evaluate": {}}
        runs, hidden = {}, {}
        if method in PRETRAINED:
            replay = None
            for name, ops in (("kernels", KERNELS), ("plain", PLAIN)):
                _build.reset_launches()
                d = os.path.join(root, method, name, "pretrain")
                pipe, r, hidden[name] = run_method_pretrain(method, gen, dev, ops,
                                                            d, replay)
                r["launches"] = dict(_build.LAUNCHES)
                runs[name] = pipe
                rec["pretrain"][name] = r
                if method == "hfc_kmeans":
                    replay = (pipe.preprocessor.hfc_model.seed_indices, hidden[name])
            kp, pp = (runs[k].preprocessor for k in ("kernels", "plain"))
            if method == "hfc_with_simclr":
                loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(kp.loss_history, pp.loss_history))
                pre_gates = {"step_loss_max_rel_err": loss_rel}
                gate(loss_rel <= STEP_LOSS_RTOL,
                     f"SimCLR step losses differ: {loss_rel} > {STEP_LOSS_RTOL}")
            else:
                center_err, fit_feature_err = 0.0, 0.0
                for a, b in zip(kp.hfc_model.centers, pp.hfc_model.centers):
                    err, _, scale = errors(a, b)
                    center_err = max(center_err, err / max(1.0, scale))
                for a, b in zip(hidden["kernels"], hidden["plain"]):
                    err, _, scale = errors(a, b)
                    fit_feature_err = max(fit_feature_err, err / max(1.0, scale))
                pre_gates = {"fit_feature_err": fit_feature_err,
                             "center_err": center_err}
                gate(fit_feature_err <= FEATURE_TOL,
                     f"the k-means fit's features differ: {fit_feature_err}")
                gate(center_err <= CENTER_TOL,
                     f"k-means centers differ: {center_err} > {CENTER_TOL}")
            rec["pretrain"]["gates"] = pre_gates
            for k in SERVING_KERNELS:
                check(rec["pretrain"]["kernels"]["launches"][k] > 0,
                      f"kernel {k} was not launched on {method}'s pretraining")
            check(all(v == 0 for v in rec["pretrain"]["plain"]["launches"].values()),
                  f"{method}'s plain pretraining launched kernels")
            runs.clear()
            hidden.clear()
        own, replay_features = {}, None
        for name, ops in (("kernels", KERNELS), ("plain", PLAIN)):
            d = os.path.join(root, method, name, "eval")
            os.makedirs(d)
            for f in PRETRAINED.get(method, []):
                shutil.copy(os.path.join(root, method, "kernels", "pretrain", f), d)
            _build.reset_launches()
            runs[name], rec["evaluate"][name], own[name] = run_method_evaluate(
                method, gen, dev, ops, d, replay_features)
            replay_features = own[name]
        kern, kr = runs["kernels"], rec["evaluate"]["kernels"]
        plain, pr = runs["plain"], rec["evaluate"]["plain"]
        for k in SERVING_KERNELS:
            check(kr["launches"][k] > 0, f"kernel {k} was not launched on {method}")
        check(all(v == 0 for v in pr["launches"].values()),
              f"{method}'s plain run launched kernels: {pr['launches']}")
        preds = kern.pred_labels
        check(preds.shape == (EVAL_TEST_SAMPLES, mc.image_size, mc.image_size),
              f"{method} labels shape {preds.shape}")
        check(bool(np.isfinite(kern.test_images).all()), "non-finite test images")
        f, pf = own["kernels"], own["plain"]
        if method == "hfc_kmeans":  # one-hot maps: the share of equal entries
            feat_gate = ("feature_agreement", (f == pf).float().mean().item())
            feat_ok = feat_gate[1] >= LABEL_AGREEMENT
        else:
            err, _, scale = errors(f, pf)
            feat_gate = ("feature_err", err / max(1.0, scale))
            feat_ok = feat_gate[1] <= FEATURE_TOL
        (e1, k1), (_, kl) = kr["finetune_losses"][0], kr["finetune_losses"][-1]
        (_, p1), (_, pl) = pr["finetune_losses"][0], pr["finetune_losses"][-1]
        gates = {feat_gate[0]: feat_gate[1],
                 "first_chunk_loss_rel": abs(k1 - p1) / max(abs(p1), 1e-30),
                 "last_loss_rel": abs(kl - pl) / max(abs(pl), 1e-30),
                 "label_agreement": float((kern.pred_labels == plain.pred_labels).mean()),
                 "mean_mask_iou_err": abs(kern.mean_mask_iou - plain.mean_mask_iou)}
        rec["evaluate"]["gates"] = gates
        try:
            rec["folded"] = check_method_folded(kern)
        except SmokeFailure as e:
            rec["folded"] = {"failed": str(e)}
            gate(False, f"{method}: {e}")
        if method == "repurposegan":
            rec["finetune_conv_choice"] = finetune_conv_choice(kern)
        pre = rec["pretrain"].get("kernels", {})
        summary = {
            "folded_ms": kr["requests"]["folded"]["steady_ms"],
            "folded_img_per_s": kr["requests"]["folded"]["img_per_s"],
            "unfused_ms": kr["requests"]["unfused"]["steady_ms"],
            "unfused_img_per_s": kr["requests"]["unfused"]["img_per_s"],
            "epoch_ms": statistics.median(kr["epoch_ms"]),
            "finetune_wall_ms": kr["finetune_wall_ms"],
            "pretrain_step_ms": (statistics.median(pre["step_ms"])
                                 if "step_ms" in pre else None),
            "fit_s": pre.get("fit_s"),
            "plain_folded_ms": pr["requests"]["folded"]["steady_ms"],
        }
        rec["summary"] = summary
        print(f"  {method}: {json.dumps({k: v for k, v in summary.items() if v is not None})}",
              flush=True)
        print(f"    gates {json.dumps(gates)}, pretraining {json.dumps(rec['pretrain'].get('gates', {}))}, "
              f"folded vs unfused {json.dumps(rec['folded'])}", flush=True)
        for name, r in rec["evaluate"].items():
            if name == "gates":
                continue
            print(f"    {name}: block ms {json.dumps({k: round(v, 3) for k, v in r['block_ms'].items()})}; "
                  f"peak GiB {json.dumps({k: round(v / 2**30, 3) for k, v in r['peak_memory_bytes'].items()})}; "
                  f"requests peak GiB folded {r['requests']['folded']['peak_memory_bytes'] / 2**30:.3f}, "
                  f"unfused {r['requests']['unfused']['peak_memory_bytes'] / 2**30:.3f}; "
                  f"launches {json.dumps(r['launches'])}; fine-tune conv {r['finetune_conv']}; "
                  f"mean mask IoU {r['mean_mask_iou']:.6f}", flush=True)
        for name in ("kernels", "plain"):
            r = rec["pretrain"].get(name)
            if r:
                print(f"    pretrain {name}: block ms {json.dumps({k: round(v, 3) for k, v in r['block_ms'].items()})}; "
                      f"peak GiB {json.dumps({k: round(v / 2**30, 3) for k, v in r['peak_memory_bytes'].items()})}"
                      + (f"; step ms {[round(t, 3) for t in r['step_ms']]}, losses {r['losses']}"
                         if "step_ms" in r else ""), flush=True)
        if "finetune_conv_choice" in rec:
            print(f"    fine-tune first conv: {json.dumps(rec['finetune_conv_choice'])}",
                  flush=True)
        gate(feat_ok, f"{method} one-shot features differ: {feat_gate}")
        gate(gates["first_chunk_loss_rel"] <= FIRST_CHUNK_LOSS_RTOL,
             f"{method} first-chunk loss differs: {gates}")
        gate(gates["last_loss_rel"] <= LAST_LOSS_RTOL, f"{method} last loss differs: {gates}")
        gate(gates["label_agreement"] >= LABEL_AGREEMENT, f"{method} labels: {gates}")
        gate(gates["mean_mask_iou_err"] <= IOU_TOL, f"{method} IoU: {gates}")
        gate(kl < k1, f"{method}'s fine-tune did not lower its loss: {k1} -> {kl}")
        check(0.0 <= kern.mean_mask_iou <= 1.0, f"mean mask IoU {kern.mean_mask_iou}")
        out[method] = rec
        # nothing of this method stays allocated into the next one's blocks
        del runs, kern, plain, own, replay_features, f, pf
    check(not failed, "phase 9 gates failed:\n  " + "\n  ".join(failed))
    return out


# ---------------------------------------------------------------------------
# phase 10: reference checkpoints and the other model configs
# ---------------------------------------------------------------------------

CONFIG_PATHS = {  # (model key, segmentor, its config file)
    "cat": ("cat-256", "hfc_with_swav_cat", "lsun_cat_256"),
    "p-horse": ("p-horse-256", "hfc_with_swav", "pascal_horse_256"),
    # the same model at all of its 34 classes, through a head as wide
    "p-horse-34": ("p-horse-256", "datasetgan", "pascal_horse_256"),
    "pidray": ("pidray-256", "hfc_with_swav_pidray", "pidray_bag_256"),
}


def seeded_generator(seed, noise_strength=True, **gen_args):
    """A full-width port Generator with random weights from ``seed`` (on the
    CPU) and, with ``noise_strength``, a random noise strength per layer
    (the init's is 0, which would hide any noise)."""
    from ganecdotes_torch.models.stylegan2.generator import Generator

    g = torch.Generator().manual_seed(seed)
    gen = Generator(**gen_args, generator=g)
    if noise_strength:
        with torch.no_grad():
            for conv in [gen.conv1, *gen.convs]:
                conv.noise_weight.fill_(0.1 + 0.4 * torch.rand((), generator=g).item())
    return gen


def rosinality_state(gen):
    """A port Generator as a rosinality ``g_ema`` state_dict (CPU tensors):
    the inverse of the layout transposes ``convert.torch_generator_tree``
    applies (HWIO -> (1, out, in, kh, kw), (in, out) -> (out, in), NHWC ->
    NCHW)."""
    from ganecdotes_torch.models.stylegan2.convert import module_tree

    tree, sd = module_tree(gen), {}

    def lin(prefix, p):
        sd[prefix + ".weight"] = p["weight"].T.contiguous()
        if "bias" in p:
            sd[prefix + ".bias"] = p["bias"].clone()

    def modconv(prefix, p):
        sd[prefix + ".weight"] = p["weight"].permute(3, 2, 0, 1)[None].contiguous()
        lin(prefix + ".modulation", p["modulation"])

    def styled(prefix, p):
        modconv(prefix + ".conv", p["conv"])
        sd[prefix + ".noise.weight"] = p["noise_weight"].reshape(1).clone()
        sd[prefix + ".activate.bias"] = p["bias"].clone()

    def to_rgb(prefix, p):
        modconv(prefix + ".conv", p["conv"])
        sd[prefix + ".bias"] = p["bias"].reshape(1, 3, 1, 1).clone()

    for i, p in enumerate(tree["style"]):
        lin(f"style.{i + 1}", p)
    sd["input.input"] = tree["input"].permute(0, 3, 1, 2).contiguous()
    styled("conv1", tree["conv1"])
    to_rgb("to_rgb1", tree["to_rgb1"])
    for i, p in enumerate(tree["convs"]):
        styled(f"convs.{i}", p)
    for i, p in enumerate(tree["to_rgbs"]):
        to_rgb(f"to_rgbs.{i}", p)
    for i, n in enumerate(tree["noises"]):
        sd[f"noises.noise_{i}"] = n.permute(0, 3, 1, 2).contiguous()
    return sd


def write_swav_reference_files(params, out_dir):
    """SwAV params (linear projection) as the reference saves them:
    ``torch.save`` of its prototype Linear and projection Sequential."""
    import torch.nn as nn

    w = params["projection"][0]["weight"].detach().cpu()  # (hlen, nclasses)
    proto = params["prototype"]
    pw, pb = proto["weight"].detach().cpu(), proto["bias"].detach().cpu()
    projection = nn.Sequential(nn.Linear(w.shape[0], w.shape[1], bias=False))
    prototype = nn.Linear(pw.shape[0], pw.shape[1])
    with torch.no_grad():
        projection[0].weight.copy_(w.T)
        prototype.weight.copy_(pw.T)
        prototype.bias.copy_(pb)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(prototype, os.path.join(out_dir, "prototypes.pt"))
    torch.save(projection, os.path.join(out_dir, "projection.pt"))


def config_copy(name, kind, extra, out_dir):
    """The port's ``configs/<kind>/<name>.py`` with assignments appended
    (later assignments win), written under ``out_dir``."""
    from ganecdotes_torch import CONFIGS_DIR

    with open(os.path.join(CONFIGS_DIR, kind, name + ".py")) as f:
        body = f.read()
    path = os.path.join(out_dir, f"{name}.py")
    with open(path, "w") as f:
        f.write(body + "\n# chip_smoke.py's overrides\n" + extra)
    return path


def _trees_equal(a, b):
    from ganecdotes_torch.selfsup.lars import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.detach().cpu(), y.detach().cpu()) for x, y in zip(la, lb))


def round_trip(dev, root):
    """(a) cat-256: a rosinality ``g_ema`` .pt written from a seeded
    full-width generator loads through the model config's ``model_path``;
    with the kernels its pipeline's one-shot image and features, and its
    mean latent, equal those of a pipeline given the source generator, bit
    for bit (the same float32 values meet the same ops). Phase 5's SwAV
    params written as the reference's prototypes.pt / projection.pt import
    to the same params, bit for bit, through the cat pipeline's SwAV
    set-up."""
    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
    from ganecdotes_torch.selfsup.swav import import_torch_swav_modules
    from ganecdotes_torch.utils.serialization import load_pytree

    model, seg, cfg_name = CONFIG_PATHS["cat"]
    d = os.path.join(root, "cat")
    os.makedirs(d)
    ckpt = os.path.join(d, "stylegan2-cat-config-f.pt")
    from ganecdotes_torch.configs.models import lsun_cat_256 as mc

    source = seeded_generator(20, **mc.gen_args)
    blocks = _Blocks()
    torch.save({"g_ema": rosinality_state(source)}, ckpt)
    cfg = {"model": config_copy(cfg_name, "models", f"model_path = {ckpt!r}\n", d)}
    _build.reset_launches()
    loaded = blocks("construct_from_checkpoint", lambda: OneShotPipeline(
        os.path.join(d, "loaded"), model=model, segmentor=seg,
        num_test_samples=EVAL_TEST_SAMPLES, custom=cfg, device=dev, ops=KERNELS))
    blocks("setup", loaded.setup)
    launches = dict(_build.LAUNCHES)
    for k in SERVING_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched loading cat-256")
    given = OneShotPipeline(os.path.join(d, "given"), model=model, segmentor=seg,
                            num_test_samples=EVAL_TEST_SAMPLES, custom=cfg,
                            device=dev, ops=KERNELS, gen=source)
    given.setup()
    same = {
        "mean_latent": torch.equal(loaded.mean_latent, given.mean_latent),
        "one_shot_image": torch.equal(loaded.one_shot_img, given.one_shot_img),
        "one_shot_features": all(torch.equal(a, b) for a, b in zip(
            loaded.one_shot_features, given.one_shot_features)),
        "state": all(torch.equal(a, b) for a, b in zip(
            loaded.model.state_dict().values(), given.model.state_dict().values())),
    }
    npz = os.path.join(ROOT, "build", "chip_smoke_swav", "swav_params.npz")
    swav_dir = os.path.join(d, "loaded")
    write_swav_reference_files(load_pytree(npz), swav_dir)
    loaded.seg_config.hfc_prep_args["train"] = False
    pre = blocks("swav_import", loaded._build_ssl_preprocessor)
    want = load_pytree(npz)
    same["swav_params"] = (_trees_equal(pre.ssl_params, want) and _trees_equal(
        import_torch_swav_modules(os.path.join(swav_dir, "prototypes.pt"),
                                  os.path.join(swav_dir, "projection.pt"),
                                  "linear"), want))
    check(all(same.values()), f"the cat-256 round trip is not bit-equal: {same}")
    return {"bit_equal": same, "block_ms": blocks.ms,
            "peak_memory_bytes": blocks.peak, "block_launches": blocks.launches,
            "checkpoint_bytes": os.path.getsize(ckpt)}


P_HORSE_XXS_CLASSES = 12  # the generic hfc_with_swav config's XXS head's outputs


def p_horse_test_set(gen, dev, d, n, k):
    """``n`` test samples for p-horse as the reference ships them, a
    latents.pt (w) and a labels.pt: each image labelled by its own
    luminance quantiles in the first ``k`` of the config's 34 classes, so
    that the one-shot label reaches class k - 1. The generic hfc_with_swav config's XXS head
    outputs 12 channels whatever the class count, and a one-shot label past
    them is refused (ROADMAP §3); DatasetGAN's pixel classifier outputs all
    34."""
    import numpy as np

    from ganecdotes_torch.models.stylegan2.generator import (
        generator_forward,
        mapping_apply,
    )
    from ganecdotes_torch.ops.opset import PLAIN

    z = torch.randn(n, 512, generator=torch.Generator().manual_seed(26)).to(dev)
    g = gen.to(dev)
    with torch.no_grad():
        w = mapping_apply(g, z, PLAIN)
        img = torch.cat([generator_forward(g, w[i : i + B], input_is_latent=True,
                                           ops=PLAIN)[0]
                         for i in range(0, n, B)]).cpu().numpy()
    gen.cpu()
    lum = img.mean(axis=-1)
    labels = np.stack([np.digitize(x, np.quantile(x, np.linspace(0, 1, k + 1)[1:-1]))
                       for x in lum])
    paths = os.path.join(d, "latents.pt"), os.path.join(d, f"labels_{k}.pt")
    torch.save(w.cpu(), paths[0])
    torch.save(torch.from_numpy(labels.astype(np.int64)), paths[1])
    return paths


def p_horse_files(dev, root):
    """(b)'s files: the g_ema .pt of a seeded generator, its per-layer NCHW
    noise maps as .pt files, one test set (``p_horse_test_set``) in the XXS
    head's 12 classes and one in all 34, the generic hfc_with_swav SwAV
    params (hlen 4864, 8000 prototypes) as the reference's files, and a
    model config pointing at them for each test set. Returns ({"p-horse":
    custom configs, "p-horse-34": ...}, SwAV files' dir, noise maps)."""
    from ganecdotes_torch.configs.models import pascal_horse_256 as mc
    from ganecdotes_torch.configs.segmentors import hfc_with_swav_config as sc
    from ganecdotes_torch.models.stylegan2.generator import make_noise
    from ganecdotes_torch.selfsup.swav import init_swav_params

    _, _, cfg_name = CONFIG_PATHS["p-horse"]
    d = os.path.join(root, "p-horse", "files")
    noise_dir = os.path.join(d, "noises")
    os.makedirs(noise_dir)
    gen = seeded_generator(21, **mc.gen_args)
    ckpt = os.path.join(d, "stylegan2-horse-config-f.pt")
    torch.save({"g_ema": rosinality_state(gen)}, ckpt)
    noises = make_noise(gen.meta, generator=torch.Generator().manual_seed(22))
    for i, n in enumerate(noises):
        torch.save(n.permute(0, 3, 1, 2).contiguous(),
                   os.path.join(noise_dir, f"noise_{i}.pt"))
    sa = sc.hfc_prep_args["swav_args"]
    write_swav_reference_files(init_swav_params(
        sa["hlen"], sa["nclasses"], sa["nprototypes"], sa["projn_nw"],
        generator=torch.Generator().manual_seed(23)), d)
    cfgs = {}
    for name, k in (("p-horse", P_HORSE_XXS_CLASSES), ("p-horse-34", len(mc.classes))):
        lat, lbl = p_horse_test_set(gen, dev, d, EVAL_TEST_SAMPLES + 1, k)
        os.makedirs(os.path.join(d, name))
        cfgs[name] = {"model": config_copy(
            cfg_name, "models",
            f"model_path = {ckpt!r}\nsample_noises = {noise_dir!r}\n"
            f"sample_latents = {lat!r}\nsample_labels = {lbl!r}\n",
            os.path.join(d, name))}
    return cfgs, d, noises


def pidray_files(dev, root):
    """(c)'s files: a seeded BagGAN generator at the reference's lean width
    map as a reference ``latest_net_G.pth`` (save_baggan_torch_checkpoint)
    in the checkpoint_dir of a copy of the BagGAN run config that also sets
    res2chlmap = "baggan"; the pidray SwAV params (hlen 2528, 4000
    prototypes) as the reference's files; the model config naming the run
    config. Returns (custom configs, SwAV files' dir, the generator)."""
    from ganecdotes_torch.configs.models import pidray_bag_256 as mc
    from ganecdotes_torch.configs.segmentors import hfc_with_swav_pidray_config as sc
    from ganecdotes_torch.models.baggan.convert import (
        BAGGAN_RES_TO_CHANNEL_MAP,
        save_baggan_torch_checkpoint,
    )
    from ganecdotes_torch.selfsup.swav import init_swav_params

    _, _, cfg_name = CONFIG_PATHS["pidray"]
    d = os.path.join(root, "pidray", "files")
    ckpt_dir = os.path.join(d, "models")
    os.makedirs(ckpt_dir)
    ga = mc.gen_args
    gen = seeded_generator(24, size=ga["size"], style_dim=ga["style_dim"],
                           n_mlp=ga["n_mlp"], res2chlmap=BAGGAN_RES_TO_CHANNEL_MAP)
    save_baggan_torch_checkpoint(os.path.join(ckpt_dir, "latest_net_G.pth"), gen)
    run = config_copy("config_pidray_unlabeled", os.path.join("models", "baggan"),
                      f"checkpoint_dir = {ckpt_dir!r}\nres2chlmap = 'baggan'\n", d)
    sa = sc.hfc_prep_args["swav_args"]
    write_swav_reference_files(init_swav_params(
        sa["hlen"], sa["nclasses"], sa["nprototypes"], sa["projn_nw"],
        generator=torch.Generator().manual_seed(25)), d)
    cfg = {"model": config_copy(cfg_name, "models", f"config_path = {run!r}\n", d)}
    return cfg, d, gen


def check_pidray_loaders(dev, root, gen):
    """The BagGAN loader's other two paths: the trainers' latest_net_G.npz of
    the same generator loads to the .pth's weights bit for bit, and a run
    config with res2chlmap = "baggan" and no checkpoint initialises the lean
    widths, whose feature pyramid is the pidray config's hlen wide."""
    from types import SimpleNamespace

    from ganecdotes_torch.configs.models import pidray_bag_256 as mc
    from ganecdotes_torch.configs.segmentors import hfc_with_swav_pidray_config as sc
    from ganecdotes_torch.models.baggan import load_baggan_generator
    from ganecdotes_torch.models.stylegan2.convert import module_tree
    from ganecdotes_torch.utils.serialization import save_pytree

    out = {}
    for name in ("npz", "none"):
        ckpt_dir = os.path.join(root, "pidray", name)
        os.makedirs(ckpt_dir)
        if name == "npz":
            save_pytree(os.path.join(ckpt_dir, "latest_net_G.npz"), module_tree(gen))
        run = config_copy("config_pidray_unlabeled", os.path.join("models", "baggan"),
                          f"checkpoint_dir = {ckpt_dir!r}\nres2chlmap = 'baggan'\n",
                          ckpt_dir)
        g = load_baggan_generator(SimpleNamespace(gen_args=mc.gen_args, config_path=run),
                                  generator=torch.Generator().manual_seed(0))
        if name == "npz":
            out["npz_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                g.state_dict().values(), gen.state_dict().values()))
        else:
            widths = [g.conv1.bias.shape[0]] + [c.bias.shape[0] for c in g.convs]
            out["random_init_width"] = sum(widths)
    check(out["npz_bit_equal"], "latest_net_G.npz did not load bit-equal")
    check(out["random_init_width"] == sc.hlen,
          f"the lean random init is {out['random_init_width']} wide, hlen {sc.hlen}")
    return out


def config_evaluate(name, dev, custom, files_dir, root, gates):
    """cli/evaluate.py's path for one model config (phase 10 (b), (c)), with
    the kernels, then with every op on its plain version fine-tuning on the
    kernels run's one-shot features; the SwAV params imported from the
    reference's files in each run's out_dir. Gated as phase 8 / 9:
    features, the replayed fine-tune's losses, test labels, mean IoU; the
    kernels run's folded request against its unfused oracle."""
    import shutil

    import numpy as np

    from ganecdotes_torch.ops import _build
    from ganecdotes_torch.ops.opset import KERNELS, PLAIN

    model, seg, _ = CONFIG_PATHS[name]
    runs, rec, own, replay = {}, {}, {}, None
    for run, ops in (("kernels", KERNELS), ("plain", PLAIN)):
        d = os.path.join(root, name, run)
        os.makedirs(d)
        for f in ("prototypes.pt", "projection.pt") if "hfc_with_swav" in seg else ():
            shutil.copy(os.path.join(files_dir, f), d)
        _build.reset_launches()
        runs[run], rec[run], own[run] = run_method_evaluate(
            seg, None, dev, ops, d, replay, model=model, custom=custom)
        replay = own[run]
    kern, kr = runs["kernels"], rec["kernels"]
    plain, pr = runs["plain"], rec["plain"]
    for k in SERVING_KERNELS:
        check(kr["launches"][k] > 0, f"kernel {k} was not launched on {name}")
    check(all(v == 0 for v in pr["launches"].values()),
          f"{name}'s plain run launched kernels: {pr['launches']}")
    mc = kern.model_config
    check(kern.pred_labels.shape == (EVAL_TEST_SAMPLES, mc.image_size, mc.image_size),
          f"{name} labels shape {kern.pred_labels.shape}")
    check(bool(np.isfinite(kern.test_images).all()), f"{name}: non-finite test images")
    check(0.0 <= kern.mean_mask_iou <= 1.0, f"{name} mean mask IoU {kern.mean_mask_iou}")
    err, _, scale = errors(own["kernels"], own["plain"])
    (e1, k1), (_, kl) = kr["finetune_losses"][0], kr["finetune_losses"][-1]
    (_, p1), (_, pl) = pr["finetune_losses"][0], pr["finetune_losses"][-1]
    g = {"feature_err": err / max(1.0, scale),
         "first_chunk_loss_rel": abs(k1 - p1) / max(abs(p1), 1e-30),
         "last_loss_rel": abs(kl - pl) / max(abs(pl), 1e-30),
         "label_agreement": float((kern.pred_labels == plain.pred_labels).mean()),
         "mean_mask_iou_err": abs(kern.mean_mask_iou - plain.mean_mask_iou)}
    try:
        folded = check_method_folded(kern)
    except SmokeFailure as e:
        folded = {"failed": str(e)}
        gates.append(f"{name}: {e}")
    widths = [int(c.bias.shape[0]) for c in [kern.model.conv1, *kern.model.convs]]
    summary = {
        "generator_widths": widths, "classes": len(mc.classes),
        "one_shot_label_max": int(kern.one_shot_label.max()),
        "hlen": (kern.preprocessor.swav_args["hlen"]
                 if "hfc_with_swav" in seg else None),
        "folded_ms": kr["requests"]["folded"]["steady_ms"],
        "folded_img_per_s": kr["requests"]["folded"]["img_per_s"],
        "unfused_ms": kr["requests"]["unfused"]["steady_ms"],
        "unfused_img_per_s": kr["requests"]["unfused"]["img_per_s"],
        "epoch_ms": statistics.median(kr["epoch_ms"]),
        "finetune_wall_ms": kr["finetune_wall_ms"],
        "score_ms_per_image": kr["score_ms_per_image"],
        "plain_folded_ms": pr["requests"]["folded"]["steady_ms"],
    }
    print(f"  {name} ({model}, {seg}): {json.dumps(summary)}", flush=True)
    print(f"    gates {json.dumps(g)}; folded vs unfused {json.dumps(folded)}",
          flush=True)
    for run, r in rec.items():
        print(f"    {run}: block ms {json.dumps({k: round(v, 3) for k, v in r['block_ms'].items()})}; "
              f"peak GiB {json.dumps({k: round(v / 2**30, 3) for k, v in r['peak_memory_bytes'].items()})}; "
              f"requests peak GiB folded {r['requests']['folded']['peak_memory_bytes'] / 2**30:.3f}, "
              f"unfused {r['requests']['unfused']['peak_memory_bytes'] / 2**30:.3f}; "
              f"launches per block {json.dumps(r['block_launches'])}; "
              f"mean mask IoU {r['mean_mask_iou']:.6f}", flush=True)
    for ok, msg in ((g["feature_err"] <= FEATURE_TOL, "one-shot features differ"),
                    (g["first_chunk_loss_rel"] <= FIRST_CHUNK_LOSS_RTOL,
                     "first-chunk loss differs"),
                    (g["last_loss_rel"] <= LAST_LOSS_RTOL, "last loss differs"),
                    (g["label_agreement"] >= LABEL_AGREEMENT, "labels differ"),
                    (g["mean_mask_iou_err"] <= IOU_TOL, "IoU differs"),
                    (kl < k1, "the fine-tune did not lower its loss")):
        if not ok:
            gates.append(f"{name}: {msg}: {g}, losses {k1} -> {kl}")
    return kern, {"kernels": kr, "plain": pr, "gates": g, "folded": folded,
                  "summary": summary}


def configs(dev):
    """Phase 10: (a) the cat-256 reference checkpoint round trip; (b)
    p-horse-256, the fed-noise family (DatasetGAN at all 34 classes, then
    the generic hfc_with_swav config in its XXS head's 12), and (c)
    pidray-256 with the BagGAN generator, each through cli/evaluate.py's
    path with the kernels and the plain ops."""
    import shutil

    root = os.path.join(ROOT, "build", "chip_smoke_configs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, failed = {}, []
    out["cat"] = round_trip(dev, root)
    print(f"  cat (cat-256): bit-equal {json.dumps(out['cat']['bit_equal'])}; "
          f"block ms {json.dumps({k: round(v, 3) for k, v in out['cat']['block_ms'].items()})}; "
          f"launches per block {json.dumps(out['cat']['block_launches'])}", flush=True)

    customs, files, noises = p_horse_files(dev, root)
    kern, out["p-horse-34"] = config_evaluate("p-horse-34", dev, customs["p-horse-34"],
                                              files, root, failed)
    s34 = out["p-horse-34"]["summary"]
    check(s34["one_shot_label_max"] == s34["classes"] - 1 == 33,
          f"the one-shot label does not reach the last of p-horse's classes: {s34}")
    del kern
    kern, out["p-horse"] = config_evaluate("p-horse", dev, customs["p-horse"], files,
                                           root, failed)
    w = kern.one_shot_latent[None]
    fed = [n.to(dev) for n in noises]
    own_buffers = kern.get_image_from_latent(w, truncate=False)
    refed = kern.get_image_from_latent(w, noise=fed, truncate=False)
    truncated = kern.get_image_from_latent(w, noise=fed)
    noise = {"fed_noise_image_bit_equal": torch.equal(kern.one_shot_img, refed),
             "differs_from_own_buffers": not torch.equal(kern.one_shot_img, own_buffers),
             "differs_from_truncated": not torch.equal(kern.one_shot_img, truncated),
             "image_max_abs_diff_vs_own_buffers":
                 (kern.one_shot_img - own_buffers).abs().max().item()}
    out["p-horse"]["fed_noise"] = noise
    print(f"    fed noise: {json.dumps(noise)}", flush=True)
    check(noise["fed_noise_image_bit_equal"] and noise["differs_from_own_buffers"]
          and noise["differs_from_truncated"],
          f"the fed noises did not reach the untruncated synthesis: {noise}")
    del kern

    custom, files, gen = pidray_files(dev, root)
    kern, out["pidray"] = config_evaluate("pidray", dev, custom, files, root, failed)
    check(sum(out["pidray"]["summary"]["generator_widths"])
          == out["pidray"]["summary"]["hlen"],
          f"the pidray features are not hlen wide: {out['pidray']['summary']}")
    del kern
    out["pidray"]["loaders"] = check_pidray_loaders(dev, root, gen)
    print(f"    BagGAN loaders: {json.dumps(out['pidray']['loaders'])}", flush=True)
    check(not failed, "phase 10 gates failed:\n  " + "\n  ".join(failed))
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

        # the rows' own bounds, each at its arithmetic's rate, summed; the
        # line is bound by what bounds most of that sum
        share = {}
        for r in per_req:
            kind = r["bound_by"].split()[0]  # "bytes" or "operations"
            share[kind] = share.get(kind, 0.0) + r["bound_ms"] * r["calls"]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(max(r["max_abs_err"], r["max_abs_err_convT_blur"] or 0.0)
                               for r in rs),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(share, key=share.get),
            "library_ms": total("library_ms"),
            **({"note": KERNEL_NOTES[name]} if name in KERNEL_NOTES else {}),
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
            if "registers" in line or "spill" in line or "Function properties" in line:
                print("  " + line.strip())
    hmma = tensor_core_instructions(info["library"])
    print(f"  tensor-core (HMMA) instructions in the SASS: {json.dumps(hmma)}", flush=True)
    check(any("styled_conv3x3" in k for k in hmma),
          "the non-up StyledConv kernel has no tensor-core instruction")

    print("kernels vs plain versions (ms per call, CUDA events):", flush=True)
    rows = check_kernels(dev) + check_sinkhorn(dev)
    print("blur and fused act at BagGAN-HQ's discriminator shapes (measured only):",
          flush=True)
    rows += check_gan_shapes(dev)
    print("the FIR kernel at BagGAN-HQ's ADA, PPL and to_rgb-backward shapes "
          "(measured only):", flush=True)
    rows += check_fir_shapes(dev)
    print("serve (ffhq-256, hfc_with_swav, B = 8):", flush=True)
    served = serve(dev)
    print(f"  steady request {served['steady_request_ms']:.3f} ms, "
          f"{served['img_per_s']:.2f} img/s; profile: {json.dumps(served['profile'])}",
          flush=True)
    print("pretrain (ffhq-256, hfc_with_swav SwAV, full config):", flush=True)
    pretrained = pretrain(dev)
    print("ADA warp pass vs plain version (ms per call, CUDA events):", flush=True)
    rows += check_resample(dev)
    print(f"train (BagGAN-HQ pidray, 256^2, B = {GAN_B}, full width and depth):",
          flush=True)
    trained = train(dev)
    print(f"evaluate (cli/evaluate.py's path: ffhq-256, hfc_with_swav_ffhq, "
          f"{EVAL_TEST_SAMPLES} test samples):", flush=True)
    evaluated = evaluate(dev)
    print(f"methods (ffhq-256: {', '.join(METHODS)}; {EVAL_TEST_SAMPLES} test "
          f"samples; SimCLR {SIMCLR_STEPS} of its 100 steps; k-means at the "
          "shipped config):", flush=True)
    other_methods = methods(dev)
    print("configs (a reference checkpoint round trip at cat-256; p-horse-256 "
          "with fed noises (datasetgan at 34 classes, hfc_with_swav at 12) and "
          "pidray-256 with the BagGAN generator through the evaluate path, "
          f"{EVAL_TEST_SAMPLES} test samples):", flush=True)
    other_configs = configs(dev)

    # each kernel's launches from the path it belongs to; the serving
    # kernel rows are per request of 8, the Sinkhorn row per SwAV step, the
    # resample rows per augment call, the fused act's backward per backward
    # of one D forward's activations at B = 20 (launches: the 5 training
    # iterations)
    launches = dict(served["launches"],
                    sinkhorn_knopp=pretrained["launches"]["sinkhorn_knopp"],
                    **{k: trained["launches"][k]
                       for k in RESAMPLE_KERNELS + ("fused_leaky_relu_bwd",)})
    line = kernels_line(rows, launches)
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"card": smi, "kind": kind, "build": info, "hmma": hmma,
                       "shapes": rows,
                       "serve": served, "pretrain": pretrained, "train": trained,
                       "evaluate": evaluated, "methods": other_methods,
                       "configs": other_configs,
                       "kernels": line}, f, indent=1)
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
