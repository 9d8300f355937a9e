"""The serving cells with a head of several convs (car512's XS head) at a
tiny size on the CPU: the work counter of the folded XS head against
``FlopCounterMode`` over the program's served form, and its count of a
car512 request; the tiny car-like cell (``tiny_fcn.py``) through the real
harness, where the program agrees with the reference, a control one
precision down and every planted fault come out not correct, a traced run
reads the cell's span metrics."""

import json
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import control
import tiny
import tiny_fcn
from faults.oneshot_server_fcn import FAULTS
from flops import stylegan2_swav_fcn_serve as counter
from harness import main, program_spans, registry, weights
from reference import stylegan2_swav_fcn as ref_mod

CFG = tiny_fcn.TINY_XS
SEEDS = [2**31 + 61, 2**31 + 62, 2**31 + 63]


def flops_of(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _car512():
    with open(os.path.join(tiny.BENCH_DIR, "configs", "car512.json")) as f:
        return json.load(f)


def test_the_head_layers_and_their_weights():
    shapes = ref_mod.weight_shapes(_car512())
    head = {k: v for k, v in shapes.items() if k.startswith("head")}
    assert head == {
        "head.0.weight": ((3, 3, 512, 16), "fan_in"), "head.0.bias": ((16,), "small"),
        "head.1.weight": ((3, 3, 16, 8), "fan_in"), "head.1.bias": ((8,), "small"),
        "head.2.weight": ((3, 3, 8, 8), "fan_in"), "head.2.bias": ((8,), "small")}
    assert ref_mod.head_layers(_car512()) == [(512, 16, 1), (16, 8, 2), (8, 8, 1)]


def test_the_folded_xs_head_per_image_as_the_program_computes_it():
    from ganecdotes_torch.selfsup.embed import project_segment_fcn

    w = weights.make(ref_mod.weight_shapes(CFG), CFG, 5, torch.device("cpu"))
    ref = ref_mod.Reference(CFG, w, torch.device("cpu"))
    z = torch.randn(2, CFG["style_dim"])
    _, feats = ref.gen.synthesis(z[:, None].expand(-1, ref.gen.n_latent, -1))
    feats = [f.permute(0, 2, 3, 1).contiguous() for f in feats]  # NHWC
    head = [{"weight": w[f"head.{i}.weight"], "bias": w[f"head.{i}.bias"]}
            for i in range(3)]
    hlen = CFG["segmentor"]["hlen"]
    one = flops_of(project_segment_fcn, [f[:1] for f in feats], w["projection"],
                   head, "XS", hlen)
    two = flops_of(project_segment_fcn, feats, w["projection"], head, "XS", hlen)
    # the folds of weights alone (a request's, not an image's) cancel
    assert two - one == counter.folded_head(CFG)
    assert counter.head_tail(CFG) == 2 * 9 * (16 * 8 + 8 * 8) * 32 * 32


def test_a_car512_request():
    cfg = _car512()
    req = counter.request(cfg, 1)
    assert 119e9 < req["synthesis_convs"] < 119.2e9  # 90.1 at 256 + 9.7 + 19.3
    assert 72e9 < req["folded_head"] < 74e9
    assert 31e9 < req["projection_sample0"] < 32e9
    b32 = counter.request(cfg, 32)
    assert b32["total"] == pytest.approx(
        32 * (req["total"] - req["projection_sample0"]) + req["projection_sample0"])
    assert 6.1e12 < b32["total"] < 6.3e12
    top = counter.level(cfg, 32, 512)
    assert [n for n, _, _ in top] == ["convs.12", "convs.13", "to_rgbs.6"]
    assert top[1][1] == 2 * 9 * 64 * 64 * 512 * 512 * 32
    levels = [counter.level(cfg, 1, 2 ** k) for k in range(2, 10)]
    assert sum(f for lv in levels for n, f, _ in lv if "rgb" not in n) \
        == req["synthesis_convs"]


def _run(tmp_path, **kwargs):
    return main.execute(tiny.args(workload=tiny_fcn.CELL, seed=2**31 + 5,
                                  seconds=0.3, **kwargs),
                        t_start=time.perf_counter(),
                        root=tiny_fcn.make_root(tmp_path), device="cpu",
                        require_chip=False)


def test_the_program_agrees_with_the_reference(tmp_path):
    line = _run(tmp_path)
    assert line["correct"] is True
    for name, c in line["checks"].items():
        assert c["value"] <= 0.05 * c["limit"], (name, c)


@pytest.mark.parametrize("fmt,correct", [("tf32", False), ("fp32", True)])
def test_the_control(tmp_path, fmt, correct):
    res = control.run(tiny_fcn.CELL, fmt, SEEDS, 0.2,
                      root=tiny_fcn.make_root(tmp_path), device="cpu",
                      require_chip=False)
    assert [line["correct"] for _, line in res] == [correct] * len(SEEDS)


@pytest.mark.parametrize("fault,number", [
    ("half_batch", "image_gap"), ("image_altered", "image_gap"),
    ("labels_altered", "label_gap"), ("z0_altered", "z0_gap")])
def test_a_broken_path_is_not_correct(tmp_path, fault, number):
    line = main.execute(tiny.args(workload=tiny_fcn.CELL, seed=2**31 + 21,
                                  seconds=0.3),
                        t_start=time.perf_counter(),
                        root=tiny_fcn.make_root(tmp_path), device="cpu",
                        require_chip=False, wrap=FAULTS[fault])
    assert line["correct"] is False
    assert float(line["checks"][number]["value"]) > line["checks"][number]["limit"]


def test_a_traced_run_reads_the_cells_span_metrics(tmp_path, monkeypatch):
    """The CPU trace has no device operation, so the device metrics are
    not read; the span metrics are, on the CPU's clock."""
    seen = []
    monkeypatch.setattr(main, "read_metrics",
                        lambda man, cell, out, traced: seen.append(out) or {})
    line = _run(tmp_path, trace=1)
    assert line["correct"] is True, line["checks"]
    out = seen[0]
    man = registry.Manifest(tiny.ROOT_DIR)
    got = {n: man.module("metrics", n).read(out, [])
           for n in ("serve.top_level_ms", "serve.top_level_roofline",
                     "serve.fcn_tail_ms")}
    assert all(v is not None and v > 0 for v in got.values()), got
    synthesis = program_spans.mean_ms(out, "serve.request", {"serve.synthesis"})
    assert got["serve.top_level_ms"] < synthesis
    # the CPU runs the plain StyledConvs: no variant launches a kernel
    assert not any(k.startswith("ops.styled.") for k in out.program_spans.counters)


def test_the_new_metrics_read_nothing_without_the_spans():
    from types import SimpleNamespace

    from ganecdotes_torch.utils.tracing import Snapshot, Span

    snap = Snapshot([Span("serve.request", 0, None, 9.0, 9.0, 9.0, 9.0, {}, {})], {})
    out = SimpleNamespace(program_spans=snap, records=[()], config={"size": 32},
                          batch=1, flops=counter, peak_flops=1e12)
    man = registry.Manifest(tiny.ROOT_DIR)
    for n in ("serve.top_level_ms", "serve.top_level_roofline", "serve.fcn_tail_ms"):
        assert man.module("metrics", n).read(out, []) is None
