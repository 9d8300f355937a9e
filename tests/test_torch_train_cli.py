"""The port's BagGAN training CLI (ganecdotes_torch/cli/train_baggan.py) on
the CPU at a tiny size: the port's pidray run config with a 16^2 generator
(narrow widths, 2 mapping layers, latent 32) and B = 2, on .npy files
through the native loader and on the JAX CLI's noise batches; its
checkpoints loaded by the JAX package's ``load_pytree`` and by the port's
``load_baggan_generator``; its losses against ``BagGANHQ`` driven by hand
on the same batches (equal: the same code and seed on one thread); and
``--chunk 2`` against ``--chunk 1`` (equal weights).
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

from ganecdotes_tpu.utils import serialization as jser
from ganecdotes_torch import CONFIGS_DIR
from ganecdotes_torch.cli import train_baggan as cli
from ganecdotes_torch.gan.train import BagGANHQ
from ganecdotes_torch.models.baggan import load_baggan_generator
from ganecdotes_torch.models.stylegan2 import convert
from ganecdotes_torch.ops import _build

from test_torch_discriminator import one_torch_thread  # noqa: F401

SIZE, LAT, B = 16, 32, 2
TINY = f"""
image_size = {SIZE}
latent_dim = {LAT}
batch_size = {B}
generator_params = dict(mlp_layers=2)
res2chlmap = {{4: 16, 8: 12, 16: 8}}
chl_multiplier = 1
d_reg_every = 2
g_reg_every = 2
n_epochs = 2
"""


def _run_config(tmp_path, extra=""):
    with open(os.path.join(CONFIGS_DIR, "models", "baggan",
                           "config_pidray_unlabeled.py")) as f:
        body = f.read()
    path = tmp_path / "tiny_baggan.py"
    path.write_text(body + TINY + extra)
    return str(path)


def _npy_dir(tmp_path, n=4):
    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.RandomState(1)
    for i in range(n):
        a = ((rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8) if i % 2
             else (rng.rand(SIZE, SIZE, 3) * 2 - 1).astype(np.float32))
        np.save(d / f"{i:02d}.npy", a)
    return str(d)


def test_cli_trains_on_npy_files_through_the_native_loader(tmp_path):
    out = tmp_path / "run"
    gan, rec = cli.run(cli.build_parser().parse_args([
        "--config", _run_config(tmp_path), "--data_dir", _npy_dir(tmp_path),
        "--out_dir", str(out), "--epochs", "2", "--device", "cpu"]))
    assert rec["source"] == "NativeDataLoader" and rec["decode_errors"] == 0
    assert rec["iters_per_epoch"] == 2  # 4 files // B
    assert len(rec["iteration_ms"]) == len(rec["batch_wait_ms"]) == 4
    assert [e["epoch"] for e in rec["epochs"]] == [1, 2]
    assert all(np.isfinite(list(e["losses"].values())).all() for e in rec["epochs"])
    ckpt = out / "checkpoints"
    names = sorted(os.path.basename(p) for p in glob.glob(str(ckpt / "*.npz")))
    assert names == ["1_net_D.npz", "1_net_G.npz", "2_net_D.npz", "2_net_G.npz",
                     "latest_net_D.npz", "latest_net_G.npz"]
    assert glob.glob(str(out / "train_*.log"))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    # the JAX package reads the generator file, leaf for leaf
    jtree = jser.load_pytree(str(ckpt / "latest_net_G.npz"))
    ours = dict(convert._flatten(convert.module_tree(gan.netG)))
    theirs = dict(convert._flatten(jtree))
    assert ours.keys() == theirs.keys()
    for k, a in theirs.items():
        np.testing.assert_array_equal(np.asarray(a), ours[k].numpy())
    # and the pidray path's loader picks it from the run config's checkpoint_dir
    run_cfg = _run_config(tmp_path, f"checkpoint_dir = {str(ckpt)!r}\n")
    g = load_baggan_generator(types.SimpleNamespace(
        gen_args={"size": SIZE, "style_dim": LAT, "n_mlp": 2}, config_path=run_cfg))
    for a, b in zip(g.state_dict().values(), gan.netG.state_dict().values()):
        assert torch.equal(a, b)


def test_cli_on_noise_equals_the_trainer_driven_by_hand(tmp_path):
    """Two iterations of the CLI on noise against BagGANHQ fed the JAX CLI's
    noise batches by hand: the same losses and weights."""
    cfg_path = _run_config(tmp_path)
    gan, rec = cli.run(cli.build_parser().parse_args([
        "--config", cfg_path, "--out_dir", str(tmp_path / "cli"), "--epochs", "1",
        "--iters_per_epoch", "2", "--device", "cpu"]))
    assert rec["source"] == "noise" and len(rec["iteration_ms"]) == 2
    hand = BagGANHQ(cli.load_run_config(cfg_path, str(tmp_path / "hand")), device="cpu")
    hand.setup_gan()
    rng = np.random.RandomState(0)
    for it in range(2):
        batch = rng.rand(B, SIZE, SIZE, 3).astype(np.float32) * 2 - 1
        hand.set_input(data_sample={"ct": batch}, iter_no=it, epoch_no=1)
        hand.optimize_parameters()
    assert rec["epochs"][0]["losses"] == hand.get_current_losses()
    for net in ("netG", "netD"):
        for a, b in zip(getattr(gan, net).state_dict().values(),
                        getattr(hand, net).state_dict().values()):
            assert torch.equal(a, b)
    # the epoch's end stepped the learning-rate policy
    assert gan.epoch == 2 and gan.optimizer_g.lr == pytest.approx(
        gan._base_lrs[0] * gan._lr_mult)


def test_cli_resumes_from_its_checkpoints(tmp_path):
    cfg_path = _run_config(tmp_path)
    out = tmp_path / "run"
    gan, _ = cli.run(cli.build_parser().parse_args([
        "--config", cfg_path, "--out_dir", str(out), "--epochs", "1",
        "--iters_per_epoch", "1", "--device", "cpu"]))
    resumed = BagGANHQ(cli.load_run_config(
        _run_config(tmp_path, "continue_train = True\nload_epoch = 'latest'\n"), str(out)),
        device="cpu", seed=5)
    resumed.setup_gan()
    for net in ("netG", "netD"):
        for a, b in zip(getattr(gan, net).state_dict().values(),
                        getattr(resumed, net).state_dict().values()):
            assert torch.equal(a, b)


def test_cli_refuses_a_chunk_and_all_bad_data(tmp_path):
    """``--chunk 2`` (once refused) now runs its two iterations in one
    optimizer call and lands on the weights of ``--chunk 1``; all-bad data
    and a missing data directory are still refused."""
    cfg_path = _run_config(tmp_path)
    runs = []
    for chunk in ("1", "2"):
        gan, rec = cli.run(cli.build_parser().parse_args([
            "--config", cfg_path, "--out_dir", str(tmp_path / f"chunk{chunk}"),
            "--epochs", "1", "--iters_per_epoch", "2", "--chunk", chunk,
            "--device", "cpu"]))
        assert sum(rec["call_iterations"]) == 2 and gan.iter_no == 2
        runs.append((gan, rec))
    assert runs[1][1]["call_iterations"] == [2]
    assert runs[0][1]["batch_sums"] == runs[1][1]["batch_sums"]
    for net in ("netG", "netD"):
        for a, b in zip(getattr(runs[0][0], net).state_dict().values(),
                        getattr(runs[1][0], net).state_dict().values()):
            assert torch.equal(a, b)
    bad = tmp_path / "bad"
    bad.mkdir()
    for i in range(2):
        np.save(bad / f"{i}.npy", np.zeros((SIZE + 1, SIZE, 3), np.float32))
    with pytest.raises(SystemExit, match="every sample failed to decode"):
        cli.main(["--config", cfg_path, "--data_dir", str(bad), "--out_dir",
                  str(tmp_path / "bad_run"), "--epochs", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no .npy files"):
        cli.main(["--config", cfg_path, "--data_dir", str(tmp_path / "data_missing"),
                  "--out_dir", str(tmp_path / "no_data"), "--device", "cpu"])


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", _run_config(tmp_path), "--out_dir", str(tmp_path / "o")])
