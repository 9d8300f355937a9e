"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.

The run finds the cell's files by name (``registry``), checks that the
machine holds the cards the cell asks for, hands the cell's traffic driver
its configuration, system, reference and work counter, and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit. The same numbers
are the last lines of standard error.

It prints no result and exits with a code other than 0 when there is no
card or too few, when a metric the cell must report finds nothing to read,
or when JAX or the JAX package was loaded into the process.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from harness import registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "ganecdotes_tpu")


class RunError(RuntimeError):
    """A run that can print no result."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``ganecdotes_torch`` is not ``ganecdotes_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def require_cards(n):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell needs {n} cards, the machine has "
                       f"{torch.cuda.device_count()}")


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_record(dev, outcome, chips):
    import torch

    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": chips}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1}
    rec["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    if outcome.trace is not None:
        rec["busy_s"] = outcome.trace.busy_s
        rec["window_s"] = outcome.trace.window_s
    if dev.type == "cuda":
        rec["power_limit"] = power_limit()
    return rec


def read_metrics(man, cell, outcome, traced):
    """{name: {value, unit}} of the cell's metrics (its per-layer ones when
    ``traced``, else its end-to-end ones), each read by
    ``metrics/<name>.py`` with the patterns of the metric, or of its
    ``SIBLING``; a metric the cell has to report that finds nothing to
    read is an error."""
    out, missing = {}, []
    metrics = man.per_layer(cell["name"]) if traced else man.end_to_end(cell["name"])
    for m in metrics:
        reader = man.module("metrics", m["name"])
        v = reader.read(outcome, man.patterns(getattr(reader, "SIBLING", m["name"])))
        if v is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    if missing:
        raise RunError(f"nothing to read for {missing} in {cell['name']}")
    return out


def execute(args, *, t_start, root=registry.ROOT_DIR, device=None,
            require_chip=True, wrap=None, system=None):
    """Run the cell; returns the result line as a dict. ``wrap`` wraps the
    driver's call into the system, ``system`` replaces the system's module
    (tests and the control; a benchmark run sets neither)."""
    import torch

    man = registry.Manifest(root)
    cell = man.cell(args.workload)
    if require_chip:
        require_cards(cell["chips"])
    dev = torch.device(device or "cuda")
    cfg = cell["config_data"]
    ctx = SimpleNamespace(
        cell=cell, config=cfg, traffic=cell["traffic_data"],
        limits=cell["limits"], seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=dev, t_start=t_start, wrap=wrap,
        system=system or man.module("systems", cfg["system"]),
        reference=man.module("reference", cfg["reference"]),
        flops=man.module("flops", cfg["flops"]))
    driver = man.module("drivers", cell["traffic_data"]["driver"])
    outcome = driver.run(ctx)
    metrics = read_metrics(man, cell, outcome, ctx.trace)
    found = forbidden_modules()
    if found:
        raise RunError(f"loaded in the run's process: {found}")
    checks = outcome.checks
    correct = all(v <= lim for v, lim in checks.values())
    line = {
        "correct": bool(correct),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_record(dev, outcome, cell["chips"]),
    }
    if outcome.trace is not None:
        line["breakdown"] = {"device_ops": trace.top(outcome.trace.device_ops),
                             "idle_gaps": trace.top(outcome.trace.idle)}
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                          "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv=None, t_start=None, **kwargs):
    """The command: prints the result line and returns 0, or prints the
    reason on standard error and returns 2. ``kwargs`` go to ``execute``."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        line = execute(args, t_start=t_start, **kwargs)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def set_cache_dirs(root=registry.ROOT_DIR):
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/kernels`` there already)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
