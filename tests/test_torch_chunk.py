"""The fused multi-iteration chunk (``BagGANHQ.optimize_parameters_chunk``,
``cli/train_baggan.py --chunk``) against single steps, on the CPU, at
tests/test_torch_gan.py's tiny config (16^2, latent 32, B 2, narrow widths,
ADA on and tuning p, style mixing on; the chunk CLI case the pidray run
config's WGAN-GP, the trainer cases the vanilla loss), as
tests/test_gan.py:564-660 holds the JAX chunk against the JAX single
steps.

The chunk takes its draws from the trainer's generator in the single-step
order and composes each iteration's ADA matrices at that iteration's p (a
device tensor), so a chunked run is the single-stepped run: the weights,
Adam's moments, ADA's state, the mean path length and the last losses are
equal bit for bit. A staged run reads no device value: the test runs it
with every host readback of a tensor made to raise.
"""

import contextlib

import numpy as np
import pytest
import torch

from ganecdotes_torch.cli import train_baggan as cli
from ganecdotes_torch.gan import train as tt
from test_torch_gan import B, SIZE, _cfg
from test_torch_train_cli import _run_config
from test_torch_discriminator import one_torch_thread  # noqa: F401

ITERS = 8


def _batches(n=ITERS, seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, SIZE, SIZE, 3) * 2 - 1).astype(np.float32) for _ in range(n)]


def _trainer(tmp_path, **over):
    """ADA at p 0.6, its controller 5 D steps into its 8: p moves after the
    D step of iteration 3, inside the first staged run (by the 6 predictions'
    sign sum over ada_length 4, to 0 or 1)."""
    # the vanilla loss: the chunk stages the D step whatever its loss, and
    # WGAN-GP's gradient of a gradient would triple the run's time here
    cfg = _cfg(tmp_path, ada_length=4, gan_mode="vanilla", **over)
    gan = tt.BagGANHQ(cfg, seed=3, device="cpu")
    gan.ada_state["p"].fill_(0.6)
    gan.ada_state["update"].fill_(5)
    return gan


def _state(gan):
    """Everything an iteration changes."""
    return ([t.clone() for t in gan.g_tensors + gan.d_tensors]
            + [t.clone() for opt in (gan.optimizer_g, gan.optimizer_d)
               for t in opt.m + opt.v]
            + [gan.ada_state[k].clone() for k in sorted(gan.ada_state)]
            + [gan.mean_path_length.clone()]
            + [getattr(gan, "loss_" + k).clone()
               for k in ("d", "d_out", "d_ref", "g_gan", "d_r1", "g_ppl")])


@contextlib.contextmanager
def no_readback():
    """Every host readback of a tensor raises (on a card each would wait for
    the device: a sync)."""
    saved = {name: getattr(torch.Tensor, name)
             for name in ("item", "tolist", "__float__", "__int__", "__bool__", "numpy")}

    def refuse(*args, **kwargs):
        raise AssertionError("a host readback inside the staged run")

    try:
        for name in saved:
            setattr(torch.Tensor, name, refuse)
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("compute_dtype,iters,runs_want", [
    (None, ITERS, [3, 0, 3, 0]), ("bfloat16", 5, [3, 0, 1])])
def test_chunk_equals_single_steps(tmp_path, compute_dtype, iters, runs_want):
    """8 iterations from iteration 1, R1 and PPL due at 4 and 8 (d_reg_every
    = g_reg_every = 4), single-stepped and as two chunks of 3 and 5 (a
    chunk boundary inside a plain run, a regularised iteration inside each
    chunk): equal bit for bit; with compute_dtype='bfloat16' the same for
    5 iterations (chunks of 3 and 2)."""
    batches = _batches(iters)
    single = _trainer(tmp_path / "single", compute_dtype=compute_dtype)
    for it, b in enumerate(batches, 1):
        single.set_input(b, iter_no=it)
        single.optimize_parameters()
    chunked = _trainer(tmp_path / "chunked", compute_dtype=compute_dtype)
    chunked.iter_no = 1
    runs = []
    real_run = chunked._run_dg_chunk

    def recording(run):
        runs.append(len(run))
        with no_readback():
            real_run(run)

    chunked._run_dg_chunk = recording
    chunked.optimize_parameters_chunk(batches[:3])
    chunked.optimize_parameters_chunk(batches[3:])
    assert chunked.iter_no == single.iter_no == iters + 1
    # staged runs: 1-3 at the first call's end; then none before the
    # regularised 4, 5-7 before the regularised 8 and none at the end (or
    # 5 at the end)
    assert runs == runs_want, runs
    assert chunked.ada_aug_p in (0.0, 1.0)  # p moved inside the run
    for a, b in zip(_state(single), _state(chunked)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_chunk_3_equals_chunk_1(tmp_path):
    """``cli/train_baggan.py --chunk 3`` against ``--chunk 1``: an epoch of 5
    iterations on the JAX CLI's noise batches (calls of 3 and 2; R1 and PPL
    every 2nd iteration), the same batches and the same weights, bit for
    bit."""
    cfg_path = _run_config(tmp_path)
    runs = []
    for chunk in ("1", "3"):
        gan, rec = cli.run(cli.build_parser().parse_args([
            "--config", cfg_path, "--out_dir", str(tmp_path / f"chunk{chunk}"),
            "--epochs", "1", "--iters_per_epoch", "5", "--chunk", chunk,
            "--device", "cpu"]))
        runs.append((gan, rec))
    (g1, r1), (g3, r3) = runs
    assert r1["call_iterations"] == [1] * 5 and r3["call_iterations"] == [3, 2]
    assert r1["batch_sums"] == r3["batch_sums"]
    assert r1["epochs"][-1]["losses"] == r3["epochs"][-1]["losses"]
    for net in ("netG", "netD"):
        for a, b in zip(getattr(g1, net).state_dict().values(),
                        getattr(g3, net).state_dict().values()):
            assert torch.equal(a, b)


def test_every_step_runs_its_backward_on_the_calling_thread(tmp_path, monkeypatch):
    """Each step kind's gradients (D with WGAN-GP's gradient of a gradient,
    R1, G, PPL: iteration 0 runs all four) are taken with the autograd
    engine's device threads off: on a card, a double backward's gradient
    graph built on the device's thread was numbered from that thread's own
    count, and the engine ran it in another order on the first run in a
    process than on later ones (chip_smoke.py's phase 16 (d))."""
    grad = torch.autograd.grad
    threaded = []

    def recording(*args, **kwargs):
        threaded.append(torch._C._is_multithreading_enabled())
        return grad(*args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", recording)
    gan = tt.BagGANHQ(_cfg(tmp_path), seed=3, device="cpu")
    gan.set_input(_batches(1)[0], iter_no=0)
    gan.optimize_parameters()
    assert len(threaded) >= 6 and not any(threaded)
    assert torch._C._is_multithreading_enabled()
