"""The port's checkpoint directories (ganecdotes_torch/utils/serialization.py
``save_pytree_orbax`` / ``load_pytree_orbax``, on torch.distributed.checkpoint)
held against the JAX package's orbax pair on the CPU.

The two directory formats differ, so each package reads back its own: the
same tree, from a numpy seed, goes through both pairs and must come back
with equal leaves, dtypes and containers. Then what only the port's pair
does: ``like`` restoring in place and refusing a mismatch, two gloo ranks
(tests/torch_ranks.py) writing one replicated tree that one process without
a process group restores, and a BagGAN-HQ trainer's state whose next
iteration repeats bit for bit. Every comparison is exact.
"""

import os
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_ranks
from ganecdotes_torch.gan import train as tt
from ganecdotes_torch.models.stylegan2.convert import _flatten
from ganecdotes_torch.utils.serialization import load_pytree_orbax, save_pytree_orbax

from test_torch_discriminator import one_torch_thread  # noqa: F401

TORCH_OF = {np.dtype(np.float32): torch.float32, np.dtype(np.int64): torch.int64,
            np.dtype(ml_dtypes.bfloat16): torch.bfloat16}


def _arrays(seed=0):
    """A tree of numpy arrays: nested dicts, a list, a tuple (and an empty
    one), float32, int64 and bfloat16 leaves, a scalar."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"w": f32(3, 4),
            "nested": {"b": f32(5).astype(ml_dtypes.bfloat16),
                       "idx": rng.randint(-2**40, 2**40, size=(2, 3), dtype=np.int64)},
            "style": [f32(2), f32(1, 2, 2)],
            "pair": (f32(4), {"count": np.asarray(7, dtype=np.int64)}),
            "empty": (),
            "scalar": np.asarray(rng.randn(), dtype=np.float32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _assert_same(ours, theirs):
    """A port tree against a JAX one: the same containers, and leaves of
    the same dtype and bits."""
    if isinstance(theirs, (dict, list, tuple)):
        assert type(ours) is type(theirs), (type(ours), type(theirs))
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            _assert_same(ours[k], theirs[k])
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_same(a, b)
    else:
        b = np.asarray(theirs)
        assert ours.dtype == TORCH_OF[b.dtype] and tuple(ours.shape) == b.shape
        a = ours.view(torch.int16).numpy() if ours.dtype == torch.bfloat16 else ours.numpy()
        assert a.tobytes() == b.tobytes()


def test_tree_round_trip_matches_jax(tmp_path):
    """The same tree through JAX's orbax pair and the port's DCP pair:
    without ``like`` both give back equal leaves and dtypes, the dicts'
    keys sorted, a tuple as a list and the empty tuple as (); with
    ``like`` both keep the tuple."""
    from ganecdotes_tpu.utils import serialization as jser

    tree = _arrays()
    jser.save_pytree_orbax(str(tmp_path / "jax"), tree)
    theirs = jser.load_pytree_orbax(str(tmp_path / "jax"))
    save_pytree_orbax(tmp_path / "port", _to_torch(tree))
    ours = load_pytree_orbax(tmp_path / "port")
    assert isinstance(theirs["pair"], list) and theirs["empty"] == ()
    assert list(ours) == sorted(ours) == list(theirs)
    _assert_same(ours, theirs)

    # with like, both give back like's containers (JAX without 64-bit
    # types restores int64 as int32, so the leaves are held to the tree)
    theirs = jser.load_pytree_orbax(str(tmp_path / "jax"), like=tree)
    like = _to_torch(_arrays(seed=1))
    ours = load_pytree_orbax(tmp_path / "port", like=like)
    assert ours is like and isinstance(theirs["pair"], tuple)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs) == jax.tree.structure(tree)
    _assert_same(ours, tree)


def test_like_restores_in_place_and_refuses_a_mismatch(tmp_path):
    """``like``'s own tensors receive the saved values (a tensor that needs
    a gradient too); a shape, a dtype, a key or a leaf that is not a tensor
    raises and casts nothing; so does a directory that holds no
    checkpoint."""
    path = tmp_path / "ckpt"
    tree = _to_torch(_arrays())
    save_pytree_orbax(path, tree)
    like = _to_torch(_arrays(seed=1))
    w = like["w"] = torch.nn.Parameter(like["w"])
    before = like["style"][1]
    load_pytree_orbax(path, like=like)
    assert like["w"] is w and like["style"][1] is before
    assert torch.equal(w.detach(), tree["w"]) and torch.equal(before, tree["style"][1])

    for change, error in (
            (lambda t: t.__setitem__("w", torch.zeros(4, 3)), ValueError),
            (lambda t: t["nested"].__setitem__("b", torch.zeros(5)), ValueError),
            (lambda t: t["nested"].__setitem__("idx", torch.zeros(2, 3, dtype=torch.int32)),
             ValueError),
            (lambda t: t.pop("scalar"), KeyError),
            (lambda t: t.__setitem__("extra", torch.zeros(1)), KeyError),
            (lambda t: t.__setitem__("scalar", 0.5), TypeError)):
        like = _to_torch(_arrays(seed=2))
        change(like)
        kept = {k: v.clone() for k, v in _flatten(like) if isinstance(v, torch.Tensor)}
        with pytest.raises(error):
            load_pytree_orbax(path, like=like)
        for k, v in _flatten(like):
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, kept[k]), k
    with pytest.raises(Exception):
        load_pytree_orbax(tmp_path / "nothing")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(Exception):
        load_pytree_orbax(tmp_path / "empty")


def _stored_bytes(path):
    """(the bytes of every DCP data file, how many times each key is stored)."""
    from torch.distributed.checkpoint import FileSystemReader

    md = FileSystemReader(str(path)).read_metadata()
    counts = {}
    for index in md.storage_data:
        counts[index.fqn] = counts.get(index.fqn, 0) + 1
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.endswith(".distcp"))
    return size, counts


def test_two_ranks_save_a_replicated_tree_once(tmp_path):
    """Two gloo ranks call ``save_pytree_orbax`` on the same replicated
    tree; one process with no process group restores it, equal to the
    tree, bf16 leaf included. Each key is stored once, and the files hold
    no more than a one-process save of the tree does, give or take
    DCP's per-file framing."""
    rng = np.random.RandomState(3)
    arrays = {"w": rng.randn(64, 48).astype(np.float32),
              "b": rng.randn(48).astype(np.float32),
              "bf16_w": rng.randn(32, 64).astype(np.float32)}
    path = tmp_path / "ranks"
    assert torch_ranks.run_ranks(torch_ranks.save_tree, 2, str(path), arrays) == [0, 1]
    out = load_pytree_orbax(path)
    want = {k: torch.from_numpy(v).to(torch.bfloat16) if k.startswith("bf16")
            else torch.from_numpy(v) for k, v in arrays.items()}
    assert set(out) == {"weights", "step"} and int(out["step"][0]) == 7
    for k, v in want.items():
        assert out["weights"][k].dtype == v.dtype and torch.equal(out["weights"][k], v)
    assert torch.equal(out["step"][1][0], want["w"])
    ranks_size, counts = _stored_bytes(path)
    assert set(counts.values()) == {1}, counts
    save_pytree_orbax(tmp_path / "one", {"weights": want, "step": (torch.tensor(7),
                                                                   [want["w"]])})
    one_size, one_counts = _stored_bytes(tmp_path / "one")
    assert one_counts == counts
    assert ranks_size <= one_size + 4096, (ranks_size, one_size)
    assert len([f for f in os.listdir(path) if f.endswith(".distcp")]) == 2


def _gan_cfg(out_dir):
    """A 32^2 BagGAN-HQ run config at narrow widths, every step kind due
    every iteration, ADA on."""
    return types.SimpleNamespace(
        out_dir=str(out_dir), checkpoint_dir=os.path.join(out_dir, "ckpt"), is_train=True,
        image_size=32, latent_dim=32, num_channels=3, batch_size=2, gan_mode="wgangp",
        use_ppl=True, r1_lambda=10, ppl_lambda=2, path_batch_shrink=2, ppl_decay=0.01,
        d_reg_every=1, g_reg_every=1, mixing_prob=0.9, chl_multiplier=1,
        res2chlmap={4: 16, 8: 12, 16: 8, 32: 8}, g_reg_ratio=1, d_reg_ratio=1,
        augment=True, augment_p=0, ada_target=0.6, ada_length=4, lr=0.002, beta1=0.0,
        lr_policy="linear", lr_params=dict(epoch_count=1, n_epochs=2, n_epochs_decay=2),
        generator_params=dict(mlp_layers=2), losses_to_print=["g_gan", "d", "g_ppl"],
        start_epoch=1, continue_train=False, load_net=False)


def _state(gan):
    return {k: v.detach().clone() for k, v in _flatten(gan.training_state())}


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    """A 32^2 trainer's two iterations, its ``training_state`` saved after
    the first: (the directory, the saved state, the state and the losses
    after the second, the real batches)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("gan_run")
    rng = np.random.RandomState(4)
    reals = [rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1 for _ in range(2)]
    gan = tt.BagGANHQ(_gan_cfg(root), seed=0, device="cpu")
    gan.ada_state["p"].fill_(0.5)
    gan.set_input(reals[0], iter_no=0)
    gan.optimize_parameters()
    path = root / "state"
    save_pytree_orbax(path, gan.training_state())
    saved = _state(gan)
    gan.set_input(reals[1])
    gan.optimize_parameters()
    torch.set_num_threads(n)
    return path, saved, _state(gan), gan.get_current_losses(), reals


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("with_like", [True, False])
def test_baggan_state_round_trip_repeats_the_next_iteration(tmp_path, gan_run, with_like):
    """A 32^2 trainer's state after one iteration (D with ADA, R1, G, PPL:
    every step kind is due every iteration) is restored into a trainer of
    another seed, onto its own tensors through ``like`` or from the tree
    without one, and equals the saved state bit for bit; its next iteration,
    drawn from its own restored generator, leaves every tensor of the
    state, the counts and the losses equal to the first run's."""
    path, saved, want, want_losses, reals = gan_run
    other = tt.BagGANHQ(_gan_cfg(tmp_path), seed=5, device="cpu")
    first = next(iter(other.netG.state_dict()))
    assert not torch.equal(other.netG.state_dict()[first], saved[f"netG.{first}"])
    if with_like:  # the nets are restored in place, before load_training_state
        like = other.training_state()
        tree = load_pytree_orbax(path, like=like)
        assert tree is like
        assert torch.equal(other.netG.state_dict()[first], saved[f"netG.{first}"])
    else:
        tree = load_pytree_orbax(path)
    other.load_training_state(tree)
    got = _state(other)
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    assert other.iter_no == 1 and other.optimizer_g.count == 2
    other.set_input(reals[1])
    other.optimize_parameters()
    got = _state(other)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert other.get_current_losses() == want_losses
