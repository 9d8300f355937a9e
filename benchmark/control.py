"""The control of a cell's comparison: the plain reference put in the
program's place, computed in a lower precision, must come out not correct.

    python3 benchmark/control.py --workload <cell> --fmt <tf32|bf16|fp8> \\
        --seeds 1 2 3 --seconds 10 [--out chiprun_out/control.json]

runs, in one process, the cell's window with the reference rounding every
matmul and convolution operand to ``--fmt`` (``reference/precision.py``)
in the program's place (``controls/<system>.py``, found by the
configuration's ``system``) and prints each seed's compared numbers beside
the cell's limits.
``--fmt program`` runs the program itself on the same seeds, the readings
the limits' lower end is set from; with ``--fault <name>`` a fault of
``faults/<system>.py`` is planted under its timed path, the readings a
training cell's upper ends are also set from. The benchmark's own runs
never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness import main, registry  # noqa: E402


def run(workload, fmt, seeds, seconds, root=registry.ROOT_DIR, device=None,
        require_chip=True, fault=None):
    """[(seed, result line)] of the cell under ``fmt``, or of the program
    with ``fault`` (``faults/<system>.py``) planted under its timed path."""
    man = registry.Manifest(root)
    cfg = man.cell(workload)["config_data"]
    system = wrap = None
    if fault is not None:
        wrap = man.module("faults", cfg["system"]).FAULTS[fault]
    if fmt != "program":
        control = man.module("controls", cfg["system"])
        system = control.Control(fmt, man.module("reference", cfg["reference"]),
                                 man.module("systems", cfg["system"]))
    out = []
    for seed in seeds:
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                                  trace=0)
        line = main.execute(args, t_start=time.perf_counter(), root=root,
                            device=device, require_chip=require_chip,
                            system=system, wrap=wrap)
        print(json.dumps({"fmt": fmt, "fault": fault, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
        out.append((seed, line))
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fmt", required=True,
                   choices=("program", "tf32", "bf16", "fp8"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", help="a fault of faults/<system>.py, planted "
                   "under the program's timed path (with --fmt program)")
    p.add_argument("--out")
    a = p.parse_args(argv)
    main.set_cache_dirs()
    res = run(a.workload, a.fmt, a.seeds, a.seconds, fault=a.fault)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            for seed, line in res:
                f.write(json.dumps({"workload": a.workload, "fmt": a.fmt,
                                    "fault": a.fault, "seed": seed, **line}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
