"""How far float32 rounding alone moves a BagGAN-HQ iteration, beside how far
the CUDA kernels move it.

The kernels sum in other orders than their plain PyTorch versions, so the
two op sets differ by float32 rounding, and the losses and gradients of a
step that differentiates through leaky ReLUs twice (R1, WGAN-GP, path
length) can move by more than the rounding wherever an input lies within
rounding of a kink. This script measures, from seeds, on the card:

1. ``tiny``: one iteration with R1 and PPL of the 32x32 BagGAN of the GPU
   tests (lr 0, ADA at p = 0.6).
   - every FIR kernel call against the float64 plain version, beside the
     float32 plain version's error;
   - the losses of the all-plain run; of the plain run with every FIR
     output moved by one rounding step (y * (1 +- 2**-24), signs from a
     seed), for eight seeds (three on the CPU); of the kernel run; and of
     the kernel run whose PPL step replays the plain run's leaky-ReLU
     decisions (``ganecdotes_torch.utils.kinks``), with how close to 0 each
     decision it changed lies;
   - with cuDNN's default and with its deterministic algorithms.
2. ``full``: iteration 0 (D, R1, G, PPL) of the pidray config that
   ``chip_smoke.py`` trains, with its learning rates: each step kind's
   gradient gap, ||a - b|| / ||b|| over the step's tensors, of the kernel
   run against the all-plain run, and of the kernel run with every FIR
   output moved by one rounding step against the kernel run.

    python3 gan_rounding.py [--phases tiny,full] [--out FILE]

``--device cpu`` runs the plain parts of ``tiny`` on the CPU (no kernel).
"""

import argparse
import json
import os
import sys
import tempfile
import types

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ganecdotes_torch import resolve_device  # noqa: E402
from ganecdotes_torch.gan.train import STEP_KINDS, BagGANHQ  # noqa: E402
from ganecdotes_torch.ops import upfirdn2d as tup  # noqa: E402
from ganecdotes_torch.ops.opset import KERNELS, PLAIN  # noqa: E402
from ganecdotes_torch.utils.kinks import KinkDecisions  # noqa: E402

LOSSES = ("d", "d_r1", "g_gan", "g_ppl")
KERNEL_FORWARD = tup._forward


def tiny_config(out_dir):
    """The GPU tests' 32x32 BagGAN (tests/test_torch_gpu.py)."""
    return types.SimpleNamespace(
        out_dir=out_dir, checkpoint_dir=out_dir, is_train=True,
        image_size=32, latent_dim=64, num_channels=3, batch_size=4,
        gan_mode="wgangp", use_ppl=True, r1_lambda=10, ppl_lambda=2,
        path_batch_shrink=2, ppl_decay=0.01, d_reg_every=16, g_reg_every=4,
        mixing_prob=0.9, chl_multiplier=1, res2chlmap={4: 64, 8: 64, 16: 32, 32: 32},
        g_reg_ratio=4 / 5, d_reg_ratio=16 / 17, augment=True, augment_p=0,
        ada_target=0.6, ada_length=500000, lr=0.0, beta1=0.0,
        generator_params=dict(mlp_layers=2), losses_to_print=list(LOSSES))


def plain_forward(x, spec):
    return tup.upfirdn2d_ref(x, spec.kernel, spec.up, spec.down, spec.pad)


def moved(forward, seed):
    """``forward`` with each output moved by one rounding step, y * (1 +-
    2**-24), the signs drawn from ``seed`` and the call's index."""
    calls = [0]

    def fwd(x, spec):
        y = forward(x, spec)
        calls[0] += 1
        gen = torch.Generator(device=y.device).manual_seed(1000003 * seed + calls[0])
        sign = torch.randint(0, 2, y.shape, generator=gen, device=y.device).to(y.dtype) * 2 - 1
        return y * (1 + sign * 2.0 ** -24)
    return fwd


def witnessed(rows):
    """The kernel's forward, each call's error against the float64 plain
    version appended to ``rows`` beside the float32 plain version's."""
    def fwd(x, spec):
        y = KERNEL_FORWARD(x, spec)
        want = tup.upfirdn2d_ref(x.double(), spec.kernel, spec.up, spec.down, spec.pad)
        scale = float(want.abs().max().clamp_min(1e-30))
        rows.append({"shape": list(x.shape), "up": spec.up, "down": spec.down,
                     "taps": [len(t) for t in spec.taps],
                     "kernel": float((y.double() - want).abs().max()) / scale,
                     "plain": float((plain_forward(x, spec).double() - want).abs().max())
                     / scale})
        return y
    return fwd


def one_iteration(cfg, dev, ops, forward=None, kinks=None, real=None, seed=2):
    """Iteration 0 (all four step kinds) with ``ops``; the FIR Function's
    forward replaced by ``forward`` and the PPL step run under ``kinks``
    where given. Returns the trainer."""
    tup._forward = forward or KERNEL_FORWARD
    try:
        gan = BagGANHQ(cfg, seed=seed, device=dev, ops=ops)
        gan.ada_state["p"].fill_(0.6)
        gan.keep_first_grads = True
        if kinks is not None:
            def ppl_step(draws, step=gan.ppl_step):
                with kinks:
                    return step(draws)
            gan.ppl_step = ppl_step
        gan.set_input(real, iter_no=0)
        gan.optimize_parameters()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        tup._forward = KERNEL_FORWARD
    gan.first_grads = {k: [g.cpu() for g in v] for k, v in gan.first_grads.items()}
    return gan


def losses(gan):
    return {k: float(getattr(gan, "loss_" + k)) for k in LOSSES}


def tiny(dev):
    cfg = tiny_config(tempfile.mkdtemp(dir=os.path.join(ROOT, "build")))
    real = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    plain_fir = PLAIN._replace(upfirdn2d=tup.upfirdn2d)  # the FIRs in the Function
    out = {}
    for det in ((False, True) if dev.type == "cuda" else (False,)):
        torch.backends.cudnn.deterministic = det
        rec = KinkDecisions()
        res = {"plain": losses(one_iteration(cfg, dev, PLAIN, kinks=rec, real=real))}
        for s in range(8 if dev.type == "cuda" else 3):
            res[f"plain, FIR outputs moved (seed {s})"] = losses(
                one_iteration(cfg, dev, plain_fir, moved(plain_forward, s), real=real))
        if dev.type == "cuda":
            rows = []
            res["kernels"] = losses(one_iteration(cfg, dev, KERNELS, witnessed(rows), real=real))
            rep = KinkDecisions(rec.masks)
            res["kernels, PPL kink decisions of the plain run"] = losses(
                one_iteration(cfg, dev, KERNELS, kinks=rep, real=real))
            res["replay"] = {"decisions": rep.calls, "tensors_changed": len(rep.flips),
                             "largest_changed_abs_over_max": max(rep.flips, default=0.0)}
            if not det:
                res["fir_calls"] = {
                    "count": len(rows),
                    "worst_kernel_err": max(r["kernel"] for r in rows),
                    "worst_plain_err": max(r["plain"] for r in rows),
                    "worst": max(rows, key=lambda r: r["kernel"])}
        key = "deterministic_cudnn" if det else "default_cudnn"
        out[key] = res
        for name, v in res.items():
            print(f"tiny [{key}] {name}: {json.dumps(v)}", flush=True)
    torch.backends.cudnn.deterministic = False
    return out


def gaps(a, b):
    """Per step kind, ||a - b|| / ||b|| over the step's gradient tensors."""
    out = {}
    for kind in STEP_KINDS:
        ga, gb = a.first_grads[kind], b.first_grads[kind]
        diff = sum(float((u - v).square().sum()) for u, v in zip(ga, gb)) ** 0.5
        norm = sum(float(v.square().sum()) for v in gb) ** 0.5
        out[kind] = diff / max(norm, 1e-30)
    return out


def full(dev):
    import chip_smoke

    cfg = chip_smoke.pidray_config(os.path.join(ROOT, "build", "gan_rounding"))
    gen = torch.Generator(device=dev).manual_seed(11)
    size = cfg.image_size
    real = torch.rand(cfg.batch_size, size, size, cfg.num_channels, generator=gen,
                      device=dev) * 2 - 1
    kern = one_iteration(cfg, dev, KERNELS, real=real, seed=0)
    kern_moved = one_iteration(cfg, dev, KERNELS, moved(KERNEL_FORWARD, 0), real=real, seed=0)
    res = {"kernels vs kernels with FIR outputs moved": gaps(kern_moved, kern)}
    del kern_moved
    plain = one_iteration(cfg, dev, PLAIN, real=real, seed=0)
    res["kernels vs plain"] = gaps(kern, plain)
    res["losses"] = {"kernels": losses(kern), "plain": losses(plain)}
    for name, v in res.items():
        print(f"full {name}: {json.dumps(v)}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="tiny,full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    res = {}
    for phase in args.phases.split(","):
        res[phase] = {"tiny": tiny, "full": full}[phase](dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
