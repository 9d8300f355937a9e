"""The harness on the CPU, with fakes in place of the card where a test
needs one: cells, configurations and metrics found by name; the result
line's keys; rates over the whole window and the tail over every request;
a metric that finds nothing fails the run; no card, no result."""

import io
import json
import os
import time
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
import torch

import tiny
from harness import main, registry, trace


def test_cells_configs_and_metrics_are_found_by_name():
    man = registry.Manifest(tiny.ROOT_DIR)
    for name in man.cells:
        cell = man.cell(name)
        cfg = cell["config_data"]
        assert cfg["name"] == cell["config"]
        for kind, key in (("systems", "system"), ("reference", "reference"),
                          ("flops", "flops")):
            assert man.module(kind, cfg[key])
        assert man.module("drivers", cell["traffic_data"]["driver"])
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
        assert [m["name"] for m in man.end_to_end(name)]
        for m in man.per_layer(name):
            assert callable(man.module("metrics", m["name"]).read)


def test_an_added_cell_and_metric_are_taken_up_as_added_files(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    before = {p: open(os.path.join(bench, p), "rb").read()
              for p in ("harness/registry.py", "harness/main.py")}
    with open(os.path.join(bench, "metrics", "serve.requests_seen.py"), "w") as f:
        f.write("def read(outcome, patterns):\n"
                "    return float(len(outcome.records)) if patterns else None\n")
    with open(os.path.join(bench, "metrics",
                           "serve.requests_seen.patterns.txt"), "w") as f:
        f.write("# a comment\nsome_kernel\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["per_layer"].append({"name": "serve.requests_seen", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "server", "moves": "serve_img_per_s",
                             "workloads": ["tiny-serve"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    m = registry.Manifest(root)
    assert "tiny-serve" in m.cells and m.cell("tiny-serve")["config_data"]["size"] == 32
    assert "serve.requests_seen" in [x["name"] for x in m.per_layer("tiny-serve")]
    assert "serve.requests_seen" not in [x["name"] for x in
                                         m.per_layer("ffhq256-serve-b32")]
    assert [p.pattern for p in m.patterns("serve.requests_seen")] == ["some_kernel"]
    outcome = SimpleNamespace(records=[(0, 1, 2)] * 3)
    reader = m.module("metrics", "serve.requests_seen")
    assert reader.read(outcome, m.patterns("serve.requests_seen")) == 3.0
    for p, data in before.items():
        assert open(os.path.join(bench, p), "rb").read() == data


def run_main(root, **kwargs):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main.main(["--workload", "tiny-serve", "--seed", str(2**31 + 11),
                        "--seconds", "0.4", "--trace", "0"], root=root,
                       device="cpu", require_chip=False, **kwargs)
    return rc, out.getvalue(), err.getvalue()


def test_the_last_line_has_the_keys_and_the_checks_come_last(tmp_path):
    rc, out, err = run_main(tiny.make_root(tmp_path))
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_img_per_s", "serve_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    last = err.strip().splitlines()[-3:]
    assert [ln.split()[1] for ln in last] == list(line["checks"])
    assert all(" limit " in ln for ln in last)


class SlowServer:
    """A fake system: every 10th request takes 60 ms, the others 10 ms."""

    def __init__(self, system):
        self.system = system
        self.n = 0

    def build(self, cfg, weights, seed, device):
        return self

    def mean_latent_z(self, cfg, seed):
        return self.system.mean_latent_z(cfg, seed)

    def serve(self, server, z):
        self.n += 1
        time.sleep(0.06 if self.n % 10 == 0 else 0.01)
        b, s = z.shape[0], 32
        return (torch.zeros(b, s, s, 3), torch.zeros(b, s, s, dtype=torch.long),
                torch.zeros(1, s, s, dtype=torch.long))


def test_rates_over_the_whole_window_and_the_tail_over_every_request(tmp_path):
    root = tiny.make_root(tmp_path)
    man = registry.Manifest(root)
    fake = SlowServer(man.module("systems", "oneshot_server"))
    line = main.execute(tiny.args(seconds=1.5), t_start=time.perf_counter(),
                        root=root, device="cpu", require_chip=False,
                        system=fake)
    n = line["attempted"]
    # 1 in 10 requests takes 60 ms: the window's rate counts them all
    expect = 4 * 10 / (9 * 0.01 + 0.06)
    assert line["metrics"]["serve_img_per_s"]["value"] == pytest.approx(expect, rel=0.15)
    # 10% of the requests are slow, so the 95th percentile is a slow one
    assert line["metrics"]["serve_p95_ms"]["value"] > 55
    assert n >= 20
    assert line["correct"] is False  # zeros are not the reference's outputs


def test_a_metric_that_finds_nothing_fails_the_run(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "metrics", "serve.styledconv_roofline.patterns.txt"),
              "w") as f:
        f.write("no_kernel_has_this_name\n")
    kernels = [("void up_gemm_kernel(float const*)", 0.0, 500.0),
               ("Memcpy DtoH (Device -> Pageable)", 600.0, 500.0)]
    outcome = SimpleNamespace(
        trace=trace.Trace(kernels, 1e-3, 1e-2, {}, {}), records=[(0, 1, 2)],
        batch=4, config=tiny.TINY, flops=registry.load_file(
            os.path.join(bench, "flops", "stylegan2_swav_serve.py"), "f"),
        peak_flops=495e12, e2e={})
    man = registry.Manifest(root)
    cell = man.cell("tiny-serve")
    with pytest.raises(main.RunError, match="serve.styledconv_roofline"):
        main.read_metrics(man, cell, outcome, traced=True)
    # with the real patterns it reads, and the device metrics read too
    man2 = registry.Manifest(tiny.make_root(tmp_path / "b"))
    got = main.read_metrics(man2, man2.cell("tiny-serve"), outcome, traced=True)
    assert set(got) == {"serve.host_ms", "serve.copy_out_ms",
                        "serve.styledconv_roofline", "serve.device_idle_pct",
                        "serve.mfu_pct"}
    assert got["serve.copy_out_ms"]["value"] == pytest.approx(0.5)
    assert 0 < got["serve.styledconv_roofline"]["value"] < 100
    assert got["serve.device_idle_pct"]["value"] == pytest.approx(90.0)


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(tiny.BENCH_DIR, "metrics"))
    if f.endswith(".py") and "SIBLING" in open(
        os.path.join(tiny.BENCH_DIR, "metrics", f)).read()))
def test_a_sibling_metric_reads_its_siblings_patterns(name, monkeypatch):
    man = registry.Manifest(tiny.ROOT_DIR)
    reader = man.module("metrics", name)
    base = reader.SIBLING
    # its patterns live in the sibling's file alone
    assert not os.path.exists(man.path("metrics", name + ".patterns.txt"))
    seen = []
    monkeypatch.setattr(reader, "read",
                        lambda outcome, patterns: seen.append(patterns) or 1.0)
    monkeypatch.setattr(man, "module", lambda kind, n: reader)
    cell = next(man.cell(c) for c in man.cells
                if name in [m["name"] for m in man.per_layer(c)])
    monkeypatch.setattr(man, "per_layer", lambda c: [{"name": name, "unit": "1"}])
    main.read_metrics(man, cell, SimpleNamespace(), traced=True)
    assert ([p.pattern for p in seen[0]]
            == [p.pattern for p in man.patterns(base)])


def test_a_traced_cpu_run_fails_without_device_operations(tmp_path):
    root = tiny.make_root(tmp_path)
    with pytest.raises(main.RunError, match="nothing to read"):
        main.execute(tiny.args(trace=1, seconds=0.3), t_start=time.perf_counter(),
                     root=root, device="cpu", require_chip=False)


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main.main(["--workload", "ffhq256-serve-b32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
    assert "no CUDA device" in err.getvalue()


def test_too_few_cards_fail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(main.RunError, match="needs 1 cards"):
        main.require_cards(1)


def test_idle_gaps_are_named_by_the_host_range():
    ev = [{"name": "bench.window", "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": 100.0},
          {"name": "bench.serve", "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": 50.0},
          {"name": "bench.to_host", "cat": "user_annotation", "ph": "X",
           "ts": 50.0, "dur": 40.0},
          {"name": "k1", "cat": "kernel", "ph": "X", "ts": 10.0, "dur": 20.0},
          {"name": "k1", "cat": "kernel", "ph": "X", "ts": 25.0, "dur": 10.0},
          {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ph": "X", "ts": 60.0,
           "dur": 20.0}]
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)  # [10, 35] and [60, 80]
    # each gap goes to the range the host was in when it began
    assert t.idle == pytest.approx({"bench.serve": 35e-6,
                                    "bench.to_host": 20e-6})
    assert t.device_ops == pytest.approx({"k1": 30e-6, "Memcpy DtoH": 20e-6})
