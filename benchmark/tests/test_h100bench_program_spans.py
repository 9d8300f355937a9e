"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the metrics that use it): each on a
synthetic snapshot, nothing where the root spans are not the window's
requests or iterations or the program has no span registry, and each on a
whole traced run of the tiny serving and training cells on the CPU."""

import sys
import time
from types import SimpleNamespace

import pytest

import tiny
from harness import main, program_spans, registry
from ganecdotes_torch.utils import tracing
from ganecdotes_torch.utils.tracing import Snapshot, Span

MAN = registry.Manifest(tiny.ROOT_DIR)
SERVE = ("serve.synthesis_ms", "serve.synthesis_host_ms", "serve.segment_ms",
         "serve.segment_host_ms", "serve.styledconv_layer_roofline")
TRAIN = ("train.d_step_ms", "train.d_grad_ms", "train.g_step_ms", "train.reg_ms",
         "train.draw_ms", "train.loader_starved_ms")


@pytest.fixture(autouse=True)
def _fresh_registry():
    tracing.stop()
    tracing.reset()
    yield
    tracing.reset()


def reader(name):
    return MAN.module("metrics", name).read


def span(name, parent, device, host=None, counters=None, id=0):
    host = device if host is None else host
    return Span(name, id, parent, host, device, host, device, {}, counters or {})


def serving_snapshot():
    """Two requests: synthesis 50 device / 60 host ms, with two StyledConv
    layers of 10 and 20 device ms; segment 30 / 5 ms."""
    spans = []
    for r in range(2):
        root = len(spans)
        spans += [span("serve.request", None, 90.0, 95.0, id=r),
                  span("serve.synthesis", root, 50.0, 60.0, id=r),
                  span("ops.styled_conv3x3", root + 1, 10.0, 2.0, id=r),
                  span("ops.styled_up_conv3x3", root + 1, 20.0, 3.0, id=r),
                  span("serve.segment", root, 30.0, 5.0, id=r)]
    return Snapshot(spans, {})


def training_snapshot():
    """Two iterations: draw 40 host ms; D 1000 (its gan.grad 700, ADA's
    gan.ada 5), R1 100 in the first, G 300 (its gan.grad 200), PPL 60 in
    the second; the loader starved 3 + 1 ms."""
    spans = []
    for it in range(2):
        spans.append(span("gan.draw", None, 40.0, id=it))
        root = len(spans)
        spans.append(span("gan.optimize", None, 1500.0, id=it))
        spans += [span("gan.d_step", root, 1000.0, id=it),
                  span("gan.ada", root + 1, 5.0, id=it),
                  span("gan.grad", root + 1, 700.0, id=it)]
        if it == 0:
            spans += [span("gan.r1", root, 100.0, id=it)]
        g = len(spans)
        spans += [span("gan.g_step", root, 300.0, id=it),
                  span("gan.grad", g, 200.0, id=it)]
        if it == 1:
            spans += [span("gan.ppl", root, 60.0, id=it)]
    return Snapshot(spans, {"loader.starved": 4.0})


def flops_stub():
    return SimpleNamespace(styled_convs=lambda cfg, b: [("a", 9e9, 0.0), ("b", 0.0, 6.7e8)])


def outcome(snap, n):
    return SimpleNamespace(program_spans=snap, records=[()] * n, config={}, batch=1,
                           flops=flops_stub(), peak_flops=1e12)


@pytest.mark.parametrize("name,expect", [
    ("serve.synthesis_ms", 50.0), ("serve.synthesis_host_ms", 60.0),
    ("serve.segment_ms", 30.0), ("serve.segment_host_ms", 5.0),
    # bound 9 ms of operations + 0.2 ms of bytes over 30 ms of layers
    ("serve.styledconv_layer_roofline", 100.0 * (9e-3 + 2e-4) / 30e-3),
])
def test_serving_readers_on_a_snapshot(name, expect):
    assert reader(name)(outcome(serving_snapshot(), 2), []) == pytest.approx(expect)


@pytest.mark.parametrize("name,expect", [
    ("train.d_step_ms", 1000.0), ("train.d_grad_ms", 700.0),
    ("train.g_step_ms", 300.0), ("train.reg_ms", 80.0), ("train.draw_ms", 40.0),
    ("train.loader_starved_ms", 2.0),
])
def test_training_readers_on_a_snapshot(name, expect):
    assert reader(name)(outcome(training_snapshot(), 2), []) == pytest.approx(expect)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_where_the_roots_are_not_the_windows(name):
    """Another number of root spans than of timed requests or iterations,
    or no span at all, reads nothing."""
    snap = serving_snapshot() if name.startswith("serve.") else training_snapshot()
    assert reader(name)(outcome(snap, 3), []) is None
    assert reader(name)(outcome(Snapshot([], {}), 2), []) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_from_a_program_without_span_registry(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "ganecdotes_torch.utils.tracing", None)
    assert reader(name)(SimpleNamespace(records=[()]), []) is None


def test_a_counter_never_counted_reads_nothing():
    snap = training_snapshot()._replace(counters={})
    assert reader("train.loader_starved_ms")(outcome(snap, 2), []) is None


def test_the_snapshot_is_read_once_a_run():
    tracing.start()
    with tracing.span("serve.request"):
        pass
    tracing.stop()
    out = SimpleNamespace(records=[()])
    first = program_spans.snapshot(out)
    tracing.reset()  # a later read takes the run's snapshot, not a new one
    assert program_spans.snapshot(out) is first
    assert program_spans.window(out, "serve.request") == (first, 1)


def traced_run(tmp_path, monkeypatch, workload):
    """A traced run of a tiny cell on the CPU, its outcome kept: the CPU
    trace has no device operation, so the device metrics are not read."""
    seen = []
    monkeypatch.setattr(main, "read_metrics",
                        lambda man, cell, out, traced: seen.append(out) or {})
    line = main.execute(tiny.args(workload=workload, trace=1, seconds=0.3),
                        t_start=time.perf_counter(), root=tiny.make_root(tmp_path),
                        device="cpu", require_chip=False)
    assert line["correct"] is True, line["checks"]
    return seen[0]


def test_a_traced_serving_run_reads_every_serving_metric(tmp_path, monkeypatch):
    out = traced_run(tmp_path, monkeypatch, "tiny-serve")
    snap, n = program_spans.window(out, "serve.request")
    assert n == len(out.records) >= 1
    got = {name: reader(name)(out, []) for name in SERVE}
    assert all(v is not None and v > 0 for v in got.values()), got
    host_ms = sum(t1 - t0 for t0, t1, _ in out.records) / n * 1e3
    assert got["serve.synthesis_host_ms"] + got["serve.segment_host_ms"] <= host_ms


def test_a_traced_training_run_reads_every_training_metric(tmp_path, monkeypatch):
    out = traced_run(tmp_path, monkeypatch, "tiny-train")
    snap, n = program_spans.window(out, "gan.optimize")
    assert n == len(out.records) >= 1
    got = {name: reader(name)(out, []) for name in TRAIN}
    assert all(v is not None for v in got.values()), got
    assert 0 < got["train.d_grad_ms"] <= got["train.d_step_ms"]
    assert got["train.g_step_ms"] > 0 and got["train.draw_ms"] > 0
    assert got["train.loader_starved_ms"] >= 0
    assert {s.id for s in snap.spans} == {it for it, *_ in out.records}
