"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

Nothing here lists a cell, a configuration, a traffic mix or a metric:

- a cell is an entry of ``workloads``; its configuration file is the
  ``file`` of the entry of ``configs`` it names, and its traffic mix is
  ``benchmark/traffic/<traffic>.json``;
- a configuration names the modules that serve it: ``system``
  (``benchmark/systems/<system>.py``, the program under test),
  ``reference`` (``benchmark/reference/<reference>.py``) and ``flops``
  (``benchmark/flops/<flops>.py``);
- a traffic mix names its ``driver`` (``benchmark/drivers/<driver>.py``);
- a cell's correctness limits are ``benchmark/limits/<cell>.json``;
- a per-layer metric is read by ``benchmark/metrics/<metric>.py`` and,
  where it matches kernel names, by the patterns in
  ``benchmark/metrics/<metric>.patterns.txt``; a metric that reads what
  another reads, for other cells, names that one as its ``SIBLING`` and
  reads the sibling's patterns file, so each list of kernels lives in one
  file.

So a later change adds a cell, a configuration, a traffic mix or a metric
by adding files and entries, and edits no file that is already here.
"""

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_DIR = os.path.dirname(BENCH_DIR)


class Manifest:
    """``BENCHMARK.json`` under ``root``, with the benchmark's folder,
    ``benchmark/``, beside it."""

    def __init__(self, root=ROOT_DIR):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def path(self, *parts):
        return os.path.join(self.bench_dir, *parts)

    def cell(self, name):
        """The cell's entry with its ``config``, ``traffic`` and ``limits``
        files read in."""
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(self.cells)}")
        entry = self.cells[name]
        cfg_entry = self.configs[entry["config"]]
        with open(os.path.join(self.root, cfg_entry["file"])) as f:
            config = json.load(f)
        with open(self.path("traffic", entry["traffic"] + ".json")) as f:
            traffic = json.load(f)
        with open(self.path("limits", name + ".json")) as f:
            limits = json.load(f)
        return dict(entry, config_data=config, traffic_data=traffic,
                    limits=limits)

    def _applies(self, metric, cell_name, e2e_names):
        if "workloads" in metric:
            return cell_name in metric["workloads"]
        return metric.get("moves") in e2e_names if "moves" in metric else True

    def end_to_end(self, cell_name):
        return [m for m in self.data["end_to_end"]
                if self._applies(m, cell_name, ())]

    def per_layer(self, cell_name):
        e2e = {m["name"] for m in self.end_to_end(cell_name)}
        return [m for m in self.data["per_layer"]
                if self._applies(m, cell_name, e2e)]

    def module(self, kind, name):
        """``benchmark/<kind>/<name>.py`` as a module."""
        return load_file(self.path(kind, name + ".py"), f"bench_{kind}_{name}")

    def patterns(self, metric_name):
        """The compiled kernel-name patterns of a metric (none if it has no
        patterns file): one regular expression a line, ``#`` comments."""
        path = self.path("metrics", metric_name + ".patterns.txt")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = [ln.split("#", 1)[0].strip() for ln in f]
        return [re.compile(ln) for ln in lines if ln]


def sibling(path, name):
    """The module ``<name>.py`` beside the file ``path``: a metric that
    reads what another reads, for other cells, is a file of two lines,
    ``SIBLING = <name>`` and ``read = sibling(__file__, SIBLING).read``."""
    return load_file(os.path.join(os.path.dirname(path), name + ".py"),
                     f"bench_sibling_{name}")


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
