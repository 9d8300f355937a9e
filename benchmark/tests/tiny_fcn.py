"""A tiny car-like cell for CPU tests, beside ``tiny.py``'s: a cell
``tiny-xs-serve`` on a 32 px generator whose top level the hlen cut leaves
out of the embedding (as car512's 512^2 level), with the XS head of three
convs (configuration ``tiny-xs``), that runs the real harness, driver,
system (``oneshot_server_fcn``) and reference (``stylegan2_swav_fcn``)."""

import json
import os
import shutil

import tiny

# levels 4: 32, 8: 32 x 2, 16: 16 x 2, 32: 16 x 2; hlen 128 ends at 16
TINY_XS = dict(
    tiny.TINY, name="tiny-xs", system="oneshot_server_fcn",
    reference="stylegan2_swav_fcn", flops="stylegan2_swav_fcn_serve",
    segmentor=dict(tiny.TINY["segmentor"], hlen=128, seg_size="XS",
                   head_widths=[16, 8], head_dilations=[1, 2, 1], head_out=8))
CELL = "tiny-xs-serve"


def make_root(tmp_path, limits_from="car512-serve-b32"):
    """``tiny.make_root``'s root with the cell ``tiny-xs-serve`` added: the
    tiny closed loop, the limits of ``limits_from``, and every metric
    car512-serve-b32 reports."""
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny-xs.json"), "w") as f:
        json.dump(TINY_XS, f)
    shutil.copy(os.path.join(bench, "limits", limits_from + ".json"),
                os.path.join(bench, "limits", CELL + ".json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "tiny-xs", "source": "a test",
                           "file": "benchmark/configs/tiny-xs.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": CELL, "config": "tiny-xs",
                             "traffic": "tiny-closed", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "car512-serve-b32" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
