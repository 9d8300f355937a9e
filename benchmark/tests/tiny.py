"""A tiny copy of the benchmark for CPU tests: the benchmark's folder and
``BENCHMARK.json`` copied under a temporary root, plus a cell
``tiny-serve`` on a 32 px generator (``tiny`` and ``tiny-bf16``) that runs
the real harness, driver, system and reference."""

import json
import os
import shutil
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_DIR = os.path.dirname(BENCH_DIR)

TINY = {
    "name": "tiny",
    "system": "oneshot_server", "reference": "stylegan2_swav",
    "flops": "stylegan2_swav_serve",
    "size": 32, "style_dim": 32, "n_mlp": 2, "channel_multiplier": 2,
    "res2chlmap": {"4": 32, "8": 32, "16": 16, "32": 16},
    "lr_mlp": 0.01, "blur_kernel": [1, 3, 3, 1], "truncation": 0.7,
    "num_latents_for_mean": 64, "label_classes": 8,
    "segmentor": {"method": "hfc_with_swav", "projn_nw": "linear",
                  "hf_interp": "nearest", "hlen": 160, "nclasses": 16,
                  "nprototypes": 20, "seg_size": "XXS", "head_out": 12},
    "inference_dtype": "float32", "reduced": [],
}
TINY_TRAIN = {
    "name": "tiny-gan", "system": "baggan_trainer", "reference": "baggan",
    "flops": "baggan_train", "size": 16, "style_dim": 32, "n_mlp": 2,
    "channel_multiplier": 2, "res2chlmap": {"4": 32, "8": 32, "16": 16},
    "lr_mlp": 0.01, "blur_kernel": [1, 3, 3, 1], "num_channels": 3,
    "batch_size": 4, "gan_mode": "wgangp", "wgangp_remat": "all", "lr": 0.002,
    "beta1": 0.0, "r1_lambda": 10, "d_reg_every": 16, "ppl_lambda": 2,
    "g_reg_every": 4, "path_batch_shrink": 2, "ppl_decay": 0.01,
    "mixing_prob": 0.9, "augment": True, "augment_p": 0.6, "ada_target": 0.6,
    "compute_dtype": "float32", "reduced": [],
}
TRAIN_TRAFFIC = {"driver": "train_loop", "files": 12, "checked_iterations": 3,
                 "warmup_iterations": 1, "trace_iterations": 16}
TRAFFIC = {"driver": "serve_closed_loop", "clients": 1, "batch": 4,
           "pool_requests": 8, "warmup_requests": 1, "check_requests": 2,
           "check_rows": 2, "trace_seconds": 1}


def make_root(tmp_path, limits_from="ffhq256-serve-b32", dtype="float32",
              train_limits_from="pidray256-train-b20"):
    """A root holding BENCHMARK.json and benchmark/ with the tiny cells
    ``tiny-serve`` and ``tiny-train`` added; their limits are those of
    ``limits_from`` and ``train_limits_from``, their type ``dtype``."""
    root = str(tmp_path)
    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT_DIR, "BENCHMARK.json")) as f:
        man = json.load(f)
    cfg = dict(TINY, inference_dtype=dtype)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny-closed.json"), "w") as f:
        json.dump(TRAFFIC, f)
    shutil.copy(os.path.join(bench, "limits", limits_from + ".json"),
                os.path.join(bench, "limits", "tiny-serve.json"))
    with open(os.path.join(bench, "configs", "tiny-gan.json"), "w") as f:
        json.dump(dict(TINY_TRAIN, compute_dtype=dtype), f)
    with open(os.path.join(bench, "traffic", "tiny-train.json"), "w") as f:
        json.dump(TRAIN_TRAFFIC, f)
    shutil.copy(os.path.join(bench, "limits", train_limits_from + ".json"),
                os.path.join(bench, "limits", "tiny-train.json"))
    man["configs"].append({"name": "tiny-gan", "source": "a test",
                           "file": "benchmark/configs/tiny-gan.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny-train", "config": "tiny-gan",
                             "traffic": "tiny-train", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        for cell, like in (("tiny-serve", "ffhq256-serve-b32"),
                           ("tiny-train", "pidray256-train-b20")):
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    man["configs"].append({"name": "tiny", "source": "a test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny-serve", "config": "tiny",
                             "traffic": "tiny-closed", "chips": 1,
                             "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def args(workload="tiny-serve", seed=2**31 + 7, seconds=0.5, trace=0):
    return types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace)
