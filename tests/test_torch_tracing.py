"""The port's span registry (``ganecdotes_torch/utils/tracing.py``) and the
spans and counters the port records into it: off, it makes no profiler
range, no CUDA event and no record; on, under a profiler or between
``start()`` and ``stop()``, each span nests under its parent, shares its id,
lies in the profiler's trace under its own name, and reports its self time,
its launches and its counters. The server, the trainer and the loader are
driven at tiny sizes on the CPU.
"""

import io
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ganecdotes_torch.gan.train import STEP_SPANS, BagGANHQ
from ganecdotes_torch.models.stylegan2.generator import Generator
from ganecdotes_torch.ops import _build
from ganecdotes_torch.pipeline.serving import OneShotServer
from ganecdotes_torch.runtime import NativeDataLoader
from ganecdotes_torch.utils import tracing

WIDTHS = {4: 16, 8: 12, 16: 8}


@pytest.fixture(autouse=True)
def fresh_registry():
    """Every test starts and ends with recording off and no record, on one
    torch thread (tiny tensors)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.stop()
    tracing.reset()
    yield
    tracing.stop()
    tracing.reset()
    torch.set_num_threads(n)


def _server():
    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=8,
                         classes=["c%d" % i for i in range(4)], gen_args={})
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(hlen=40, nclasses=8, nprototypes=16,
                                          projn_nw="linear", hf_interp="nearest")),
        seg_args=dict(size="XXS"))
    gen = Generator(16, style_dim=32, n_mlp=2, res2chlmap=WIDTHS,
                    generator=torch.Generator().manual_seed(0))
    return OneShotServer(mc, sc, device="cpu", gen=gen, seed=1)


def _trainer(tmp_path):
    cfg = SimpleNamespace(
        out_dir=str(tmp_path), checkpoint_dir=str(tmp_path), is_train=True,
        image_size=16, latent_dim=32, num_channels=3, batch_size=2,
        gan_mode="wgangp", use_ppl=True, r1_lambda=10, ppl_lambda=2,
        path_batch_shrink=2, ppl_decay=0.01, d_reg_every=2, g_reg_every=2,
        mixing_prob=0.9, chl_multiplier=1, res2chlmap=WIDTHS, g_reg_ratio=2 / 3,
        d_reg_ratio=2 / 3, augment=True, augment_p=0.6, ada_target=0.6,
        ada_length=100, lr=0.002, beta1=0.0, generator_params=dict(mlp_layers=2),
        losses_to_print=["g_gan", "d", "g_ppl"])
    return BagGANHQ(cfg, seed=3, device="cpu")


def _serve(server):
    server.serve(torch.randn(2, 32, generator=torch.Generator().manual_seed(5)))


def _iterate(gan):
    rng = np.random.RandomState(4)
    gan.set_input(rng.randn(2, 16, 16, 3).astype(np.float32), iter_no=0)
    gan.optimize_parameters()


def _spans(tmp_path):
    with tracing.span("a"):
        with tracing.span("b", id=3):
            tracing.count("n", 2)


@pytest.mark.parametrize("work", ["spans", "server", "trainer"])
def test_off_makes_no_range_no_event_and_no_record(work, tmp_path, monkeypatch):
    """With recording off a span is the shared null context: the work makes
    no ``record_function`` call, constructs no CUDA event and leaves no
    record or counter."""
    made = {"range": 0, "event": 0}
    record_function, event = torch.profiler.record_function, torch.cuda.Event

    def counted(kind, real):
        def make(*args, **kwargs):
            made[kind] += 1
            return real(*args, **kwargs)
        return make

    monkeypatch.setattr(torch.profiler, "record_function", counted("range", record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted("range", record_function))
    monkeypatch.setattr(torch.cuda, "Event", counted("event", event))
    assert not tracing.recording()
    assert tracing.span("x") is tracing.span("y")
    if work == "spans":
        _spans(tmp_path)
    elif work == "server":
        _serve(_server())
    else:
        _iterate(_trainer(tmp_path))
    assert made == {"range": 0, "event": 0}
    assert tracing.snapshot() == tracing.Snapshot([], {})


def test_spans_record_under_a_profiler_and_lie_in_its_trace(tmp_path):
    """A CPU ``torch.profiler`` session turns recording on; each span is a
    range of the same name in the exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        with tracing.span("outer.layer"):
            with tracing.span("inner.layer"):
                torch.ones(4).sum()
    assert not tracing.recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"outer.layer", "inner.layer"} <= names
    assert [s.name for s in tracing.snapshot().spans] == ["outer.layer", "inner.layer"]


def test_start_and_stop_bound_the_recording():
    with tracing.span("before"):
        pass
    tracing.start()
    assert tracing.recording()
    with tracing.span("during"):
        pass
    tracing.stop()
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.snapshot().spans] == ["during"]


def test_nesting_parents_and_shared_ids():
    """A child's parent is the span it opened in; its id is its parent's
    unless given; a root without one takes a fresh id."""
    tracing.start()
    with tracing.span("req"):
        with tracing.span("stage"):
            with tracing.span("op"):
                pass
        with tracing.span("stage2"):
            pass
    with tracing.span("req"):
        with tracing.span("stage"):
            pass
    with tracing.span("iteration", id=7):
        with tracing.span("step"):
            with tracing.span("other", id=9):
                with tracing.span("leaf"):
                    pass
    spans = tracing.snapshot().spans
    names = [s.name for s in spans]
    assert names == ["req", "stage", "op", "stage2", "req", "stage", "iteration",
                     "step", "other", "leaf"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None, 4, None, 6, 7, 8]
    ids = [s.id for s in spans]
    assert ids[:4] == [ids[0]] * 4 and ids[4:6] == [ids[4]] * 2
    assert ids[0] != ids[4]
    assert ids[6:] == [7, 7, 9, 9]


@pytest.mark.parametrize("children", [0, 1, 3])
def test_self_time_is_the_duration_less_the_children(children):
    """On the CPU a span's device time is its host time; its self time is
    its duration less what its children cover."""
    tracing.start()
    with tracing.span("parent"):
        time.sleep(0.01)
        for _ in range(children):
            with tracing.span("child"):
                time.sleep(0.02)
    spans = tracing.snapshot().spans
    parent, kids = spans[0], spans[1:]
    assert len(kids) == children
    covered = sum(k.host_ms for k in kids)
    assert parent.self_host_ms == pytest.approx(parent.host_ms - covered)
    assert parent.self_device_ms == pytest.approx(parent.device_ms - covered)
    assert parent.device_ms == parent.host_ms
    assert parent.self_host_ms >= 10.0
    assert all(k.host_ms >= 20.0 and k.self_host_ms == k.host_ms for k in kids)
    assert parent.host_ms >= 10.0 + 20.0 * children


def test_counters_go_to_the_innermost_span_and_sum_up():
    tracing.start()
    tracing.count("loose", 1.5)
    with tracing.span("a"):
        tracing.count("n")
        with tracing.span("b"):
            tracing.count("n", 2)
            tracing.count("m", 4)
    tracing.stop()
    tracing.count("loose", 100)  # recording off: not counted
    snap = tracing.snapshot()
    a, b = snap.spans
    assert b.counters == {"n": 2, "m": 4}
    assert a.counters == {"n": 3, "m": 4}
    assert snap.counters == {"loose": 1.5, "n": 3, "m": 4}


def test_snapshot_and_reset_refuse_an_open_span():
    tracing.start()
    with tracing.span("open"):
        with pytest.raises(RuntimeError, match="open"):
            tracing.snapshot()
        with pytest.raises(RuntimeError, match="open"):
            tracing.reset()
    assert len(tracing.snapshot().spans) == 1
    tracing.reset()
    assert tracing.snapshot().spans == []


def test_launches_are_credited_to_the_innermost_span(monkeypatch):
    """``_build.launch`` counts every launch in ``LAUNCHES`` and credits it,
    while a span is open, to the innermost one; a span's launches include
    its children's."""
    monkeypatch.setattr(_build, "_lib", SimpleNamespace(entry=lambda *a: 0))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    _build.launch("upfirdn2d", "entry")  # recording off
    tracing.start()
    with tracing.span("step"):
        _build.launch("upfirdn2d", "entry")
        with tracing.span("inner"):
            _build.launch("upfirdn2d", "entry")
            _build.launch("styled_conv3x3", "entry")
    _build.launch("upfirdn2d", "entry")  # no span open
    step, inner = tracing.snapshot().spans
    assert inner.launches == {"upfirdn2d": 1, "styled_conv3x3": 1}
    assert step.launches == {"upfirdn2d": 2, "styled_conv3x3": 1}
    assert _build.LAUNCHES["upfirdn2d"] == 4 and _build.LAUNCHES["styled_conv3x3"] == 1


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_server_request_spans():
    """``OneShotServer.serve``: a root ``serve.request`` a call, with an id
    of its own, over ``serve.synthesis`` (which holds every StyledConv
    layer) and ``serve.segment`` (which holds none)."""
    server = _server()
    tracing.start()
    _serve(server)
    _serve(server)
    spans = tracing.snapshot().spans
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["serve.request"] * 2
    assert spans[roots[0]].id != spans[roots[1]].id
    for r in roots:
        assert _children(spans, r) == ["serve.synthesis", "serve.segment"]
        synth = next(i for i, s in enumerate(spans)
                     if s.parent == r and s.name == "serve.synthesis")
        segment = synth + 1 + sum(s.parent == synth for s in spans)
        convs = _children(spans, synth)
        # 16 px: conv1 at 4, an up and a non-up layer at 8 and at 16
        assert convs == ["ops.styled_conv3x3", "ops.styled_up_conv3x3",
                         "ops.styled_conv3x3", "ops.styled_up_conv3x3",
                         "ops.styled_conv3x3"]
        assert spans[segment].name == "serve.segment" and not _children(spans, segment)
    assert {s.id for s in spans[roots[0]:roots[1]]} == {spans[roots[0]].id}


def test_trainer_iteration_spans(tmp_path):
    """A ``BagGANHQ`` iteration with R1 and PPL due: ``gan.draw`` (the
    draws) and ``gan.optimize`` roots with the iteration as id, the four
    steps under ``gan.optimize``, ``gan.grad`` in each and ``gan.ada`` in
    every step that augments; the next iteration's spans take its id."""
    gan = _trainer(tmp_path)
    tracing.start()
    _iterate(gan)
    gan.set_input(np.zeros((2, 16, 16, 3), np.float32), iter_no=1)
    gan.optimize_parameters()
    spans = tracing.snapshot().spans
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["gan.draw", "gan.optimize"] * 2
    assert [spans[i].id for i in roots] == [0, 0, 1, 1]
    opt0, opt1 = roots[1], roots[3]
    assert _children(spans, opt0) == [STEP_SPANS[k] for k in ("d", "r1", "g", "ppl")]
    assert _children(spans, opt1) == [STEP_SPANS["d"], STEP_SPANS["g"]]
    for i, s in enumerate(spans):
        assert s.id == (0 if i < roots[2] else 1)
        if s.name in STEP_SPANS.values():
            kids = _children(spans, i)
            assert kids.count("gan.grad") == 1
            assert ("gan.ada" in kids) == (s.name != "gan.ppl")
    d_step = _children(spans, opt0).index("gan.d_step")
    assert d_step == 0 and spans[opt0 + 1].name == "gan.d_step"


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _feed(fifo, payload, delay, done):
    """Write ``payload`` to each reader of ``fifo``, from ``delay`` s on,
    until ``done``."""
    time.sleep(delay)
    while not done.is_set():
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError:  # no reader yet
            time.sleep(0.001)
            continue
        try:
            os.write(fd, payload)
        except OSError:  # the reader left
            pass
        finally:
            os.close(fd)


def test_loader_counts_the_time_next_is_starved(tmp_path):
    """``loader.starved`` counts the ms ``next`` waited on an empty queue:
    hundreds while the worker is held back (its file, a FIFO, is written
    0.3 s late), none once the worker is ahead, nothing while recording is
    off."""
    fifo = str(tmp_path / "img.npy")
    os.mkfifo(fifo)
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    done = threading.Event()
    feeder = threading.Thread(target=_feed, args=(fifo, _npy(img), 0.3, done),
                              daemon=True)
    loader = NativeDataLoader([fifo], 1, 4, 4, 3, queue_depth=1, n_threads=1,
                              shuffle=False)
    try:
        feeder.start()
        tracing.start()
        first = loader.next()
        held = tracing.snapshot().counters
        tracing.reset()
        time.sleep(0.3)  # the worker refills the queue
        second = loader.next()
        ahead = tracing.snapshot().counters
        tracing.reset()
        tracing.stop()
        loader.next()
        off = tracing.snapshot().counters
    finally:
        loader.close()
        done.set()
        feeder.join(timeout=10)
    assert not feeder.is_alive()
    expect = img.astype(np.float32)[None] / np.float32(127.5) - np.float32(1.0)
    np.testing.assert_array_equal(first, expect)
    np.testing.assert_array_equal(second, expect)
    assert held["loader.starved"] >= 150.0
    assert ahead == {"loader.starved": 0.0}
    assert off == {}
