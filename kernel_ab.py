#!/usr/bin/env python3
"""Time the port's StyledConv and Sinkhorn kernels of two checkouts in turns
on one GPU, so that a change is compared with its parent on the same card.

    python3 kernel_ab.py BASE_DIR NEW_DIR [--rounds N] [--out PATH]

Each turn is a fresh process that imports ``ganecdotes_torch`` and the
helpers of ``chip_smoke.py`` from one checkout (building that checkout's
kernels under its own ``build/``) and times, with CUDA events, at the shapes
of the ffhq-256 serving request (B = 8) and the SwAV step:

  * styled_conv3x3 and styled_up_conv3x3, ms per request (each layer's time
    summed over the request's calls), and per layer;
  * sinkhorn_knopp at (patch_size, nprototypes) = (20000, 5000), niters 10,
    ms per call.

The turns of a round run base, new, new, base. One JSON line per turn, then
the medians per checkout and the ratio new / base.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CONVS = ("styled_conv3x3", "styled_up_conv3x3")


def worker(root):
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ganecdotes_torch import resolve_device
    from ganecdotes_torch.ops import modulated_conv, sinkhorn
    from ganecdotes_torch.ops._build import load

    dev = resolve_device("cuda")
    load()
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
    print(json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("base")
    parser.add_argument("new")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--out", help="write the turns and the summary to this JSON file")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
        return 0
    turns = []
    for _ in range(args.rounds):
        for side in ("base", "new", "new", "base"):
            root = os.path.abspath(getattr(args, side))
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "x", "x",
                                  "--worker", root], cwd=root, capture_output=True,
                                 text=True, check=True)
            turn = {"side": side, **json.loads(res.stdout.strip().splitlines()[-1])}
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    summary = {}
    for kernel in CONVS + ("sinkhorn_knopp",):
        med = {side: statistics.median(t[kernel]["ms"] for t in turns if t["side"] == side)
               for side in ("base", "new")}
        summary[kernel] = {**med, "new_over_base": med["new"] / med["base"]}
    print(json.dumps({"summary": summary}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
