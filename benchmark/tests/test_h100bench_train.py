"""The training cell on the CPU at a tiny size (a 16 px BagGAN, B = 4):
the program's plain path against the plain reference through a whole run
of the harness; the run with the timed path broken underneath, once for
each fault a one-card training cell can have; and the control (the
reference in TF32 in the program's place). Each fault is judged against
the training cell's limits."""

import math
import time
from types import SimpleNamespace

import pytest
import torch

import control
import tiny
from faults.baggan_trainer import gradient_altered, half_batch, state_unchanged
from harness import main

LIMITS = "pidray256-train-b20"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def run(tmp_path, wrap=None, seed=2**31 + 5):
    root = tiny.make_root(tmp_path, train_limits_from=LIMITS)
    return main.execute(tiny.args(workload="tiny-train", seed=seed, seconds=0.1),
                        t_start=time.perf_counter(), root=root, device="cpu",
                        require_chip=False, wrap=wrap)


def test_the_program_agrees_with_the_reference(tmp_path):
    line = run(tmp_path)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["batch_mismatch"]["value"] == 0
    assert line["checks"]["loss_d0"]["value"] < 1e-5
    assert line["checks"]["grad_d"]["value"] < 1e-4
    assert set(line["metrics"]) == {"train_img_per_s", "setup_s"}


def test_the_window_draws_through_the_trainer(tmp_path):
    """The checked iterations take the benchmark's draws; every later one,
    the warm-up's and the window's, calls the trainer as the CLI does."""
    calls = []

    def record(step):
        def wrapped(gan, batch, it, d=None):
            calls.append((it, d is None))
            step(gan, batch, it, d)
        return wrapped

    line = run(tmp_path, wrap=record)
    assert line["correct"] is True, line["checks"]
    assert calls[:4] == [(0, False), (1, False), (2, False), (3, True)]
    assert len(calls) == 4 + line["attempted"] and all(own for _, own in calls[3:])
    assert [it for it, _ in calls] == list(range(len(calls)))


def test_a_traced_window_holds_one_r1_period(tmp_path, monkeypatch):
    """The window alone, with a fake step: 16 iterations from 4, R1 at 16."""
    from drivers import train_loop
    from harness import registry

    man = registry.Manifest(tiny.make_root(tmp_path, train_limits_from=LIMITS))
    cell = man.cell("tiny-train")
    ctx = SimpleNamespace(
        config=cell["config_data"], traffic=cell["traffic_data"], seed=2**31 + 9,
        seconds=600.0, trace=True, device=torch.device("cpu"),
        t_start=time.perf_counter(), flops=man.module("flops", "baggan_train"))
    monkeypatch.setattr(train_loop.trace, "profiler", lambda dev: None)
    seen = []
    out = train_loop.window(ctx, None, SimpleNamespace(next=lambda: None),
                            lambda gan, batch, it: seen.append(it), 4)
    assert seen == list(range(4, 20)) and out.attempted == 16
    assert sum(it % ctx.config["d_reg_every"] == 0 for it in seen) == 1


@pytest.mark.parametrize("fault,numbers", [
    (state_unchanged, ("grad_d", "change_gap", "image_gap")),
    (half_batch, ("loss_d0", "image_gap")),
    (gradient_altered, ("grad_d", "grad_r1")),
])
def test_a_broken_path_is_not_correct(tmp_path, fault, numbers):
    line = run(tmp_path, wrap=fault)
    assert line["correct"] is False
    for n in numbers:
        c = line["checks"][n]
        assert float(c["value"]) > c["limit"], (n, c)


def test_the_control_in_tf32_is_not_correct(tmp_path):
    root = tiny.make_root(tmp_path, train_limits_from=LIMITS)
    res = control.run("tiny-train", "tf32", [2**31 + 51], 0.1, root=root,
                      device="cpu", require_chip=False)
    (_, line), = res
    assert line["correct"] is False, line["checks"]
    assert math.isfinite(float(line["checks"]["grad_d"]["value"]))
    c = line["checks"]["image_gap"]
    assert c["limit"] < float(c["value"]) < 1, c
