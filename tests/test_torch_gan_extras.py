"""The GAN modules no trainer path calls, held against the JAX package on
the CPU: the four auxiliary losses (gan/losses.py), ``ImagePool``
(gan/image_pool.py), the discriminator's InfoGAN Q heads
(models/stylegan2/discriminator.py ``DiscriminatorQ``,
``discriminator_forward_q``) and ``initialize_params`` (gan/train.py).

Inputs are numpy arrays made from a seed and handed to both packages. The
Q-head trees are built with numpy at narrow widths (as
tests/test_torch_discriminator.py builds the discriminator's): the same tree
goes into JAX's ``discriminator_forward_q`` and, through
``convert.from_jax_discriminator_q_params``, into the port.

Tolerances: losses 1e-6 absolute + 1e-5 relative (a few float32 reductions
in another order); the Q heads' outputs as the discriminator's logits,
1e-5 absolute + 1e-4 relative; the pool's outputs equal bit for bit (it
copies images); ``initialize_params`` by its statistics (its draws are
torch's, not JAX's): biases exactly zero, each weight's sample standard
deviation within 5% of the init's (at least 4096 draws a tensor), and the
orthogonal init's Q^T Q within 1e-4 of the identity.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.gan import losses as jl
from ganecdotes_tpu.gan.image_pool import ImagePool as JImagePool
from ganecdotes_tpu.models.stylegan2 import discriminator as jd
from ganecdotes_torch.gan import ImagePool, initialize_params
from ganecdotes_torch.gan import losses as tl
from ganecdotes_torch.models.stylegan2 import convert
from ganecdotes_torch.models.stylegan2 import discriminator as td
from ganecdotes_torch.ops.opset import PLAIN

from test_torch_discriminator import disc_tree, one_torch_thread  # noqa: F401

LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
WIDTHS = {16: 8, 8: 12, 4: 16}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _loss_inputs(name, rng):
    if name == "logistic_loss":
        return rng.randn(6, 1), rng.randn(6, 1)
    if name == "nonsaturating_loss":
        return (rng.randn(6, 1),)
    if name == "normal_nll_loss":
        return rng.randn(4, 3), rng.randn(4, 3), rng.rand(4, 3) + 0.1
    soft = rng.rand(2, 5, 5, 3)
    return soft / soft.sum(-1, keepdims=True), (rng.rand(2, 5, 5, 3) > 0.5) * 1.0


@pytest.mark.parametrize("name", ["logistic_loss", "nonsaturating_loss",
                                  "normal_nll_loss", "dice_loss"])
def test_losses_match_jax(name):
    args = [a.astype(np.float32) for a in _loss_inputs(name, np.random.RandomState(3))]
    want = getattr(jl, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tl, name)(*[_t(a) for a in args])
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_losses_at_known_values():
    """tests/test_gan.py's values: the NLL of a standard normal at its mean,
    the Dice loss of a map with itself and with zeros."""
    nll = float(tl.normal_nll_loss(torch.zeros(2, 3), torch.zeros(2, 3), torch.ones(2, 3)))
    assert abs(nll - 0.5 * np.log(2 * np.pi) * 3) < 1e-3
    a = torch.ones(1, 4, 4, 2)
    assert abs(float(tl.dice_loss(a, a))) < 1e-5
    assert abs(float(tl.dice_loss(a, 0 * a)) - 1.0) < 1e-4


def test_image_pool_matches_jax_output_for_output():
    """The same seed and the same batches: every query's output equals the
    JAX pool's, through the filling, the swaps and the pass-throughs."""
    rng = np.random.RandomState(0)
    ours, theirs = ImagePool(3, seed=7), JImagePool(3, seed=7)
    for _ in range(6):
        imgs = rng.randn(2, 4, 4, 3).astype(np.float32)
        got = ours.query(torch.from_numpy(imgs))
        want = theirs.query(imgs)
        assert isinstance(got, torch.Tensor) and got.shape == (2, 4, 4, 3)
        np.testing.assert_array_equal(got.numpy(), want)
    assert ours.num_imgs == theirs.num_imgs == 3
    for a, b in zip(ours.images, theirs.images):
        np.testing.assert_array_equal(a.numpy(), b)


def test_image_pool_semantics():
    imgs = torch.arange(4 * 2 * 2 * 1, dtype=torch.float32).reshape(4, 2, 2, 1)
    assert ImagePool(0).query(imgs) is imgs  # pool_size 0 passes through
    pool = ImagePool(2, seed=0)
    assert torch.equal(pool.query(imgs[:2]), imgs[:2])  # fills the buffer
    assert pool.num_imgs == 2
    out = pool.query(imgs[2:])
    seen = {float(im.sum()) for im in imgs}
    assert out.shape == (2, 2, 2, 1) and all(float(im.sum()) in seen for im in out)
    # the pool keeps copies: changing the query's images leaves it alone
    before = [im.clone() for im in pool.images]
    imgs.zero_()
    assert all(torch.equal(a, b) for a, b in zip(before, pool.images))


def _q_tree(q_layers, n_cat_c, n_classes, n_cont_c, seed=4):
    """A JAX ``init_discriminator_q`` tree at narrow widths: the trunk from
    disc_tree, each head's tail with its own weights."""
    base = disc_tree(16, WIDTHS, seed=seed)
    rng = np.random.RandomState(seed + 1)
    n = len(base["blocks"])

    def jitter(tree):
        return jax.tree.map(lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32),
                            copy.deepcopy(tree))

    def lin(cin, cout):
        return {"weight": rng.randn(cin, cout).astype(np.float32),
                "bias": (0.1 * rng.randn(cout)).astype(np.float32)}

    def tail(lin1, lin2):
        return {"blocks": jitter(base["blocks"][n - q_layers:]),
                "final_conv": jitter(base["final_conv"]), "lin1": lin1, "lin2": lin2}

    c4 = WIDTHS[4]
    tree = {"conv_in": base["conv_in"], "blocks_adv": base["blocks"][:n - q_layers],
            "d": tail(base["final_lin1"], base["final_lin2"])}
    if n_cat_c:
        tree["q_cat"] = tail(lin(c4 * 16, c4), lin(c4, n_cat_c * n_classes))
    if n_cont_c:
        tree["q_cont"] = tail(lin(c4 * 16, c4), lin(c4, n_cont_c * 2))
    meta = dict(jd.discriminator_meta(16), q_layers=q_layers, n_cat_c=n_cat_c,
                n_classes=n_classes, n_cont_c=n_cont_c)
    return tree, meta


@pytest.mark.parametrize("q_layers,n_cat_c,n_cont_c", [(1, 2, 3), (2, 1, 0), (0, 0, 2)])
def test_discriminator_q_matches_jax(q_layers, n_cat_c, n_cont_c):
    """The JAX Q tree carried across: the adversarial logits, the softmax
    codes and the tanh codes equal JAX's discriminator_forward_q's."""
    tree, meta = _q_tree(q_layers, n_cat_c, 5, n_cont_c)
    x = np.random.RandomState(6).randn(4, 16, 16, 3).astype(np.float32)
    want = jd.discriminator_forward_q(jax.tree.map(jnp.asarray, tree), meta, jnp.asarray(x))
    d = convert.from_jax_discriminator_q_params(tree, meta)
    for ops in (PLAIN, None):
        got = (td.discriminator_forward_q(d, _t(x), PLAIN) if ops is not None
               else d(_t(x)))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **OUT_TOL)
    if n_cat_c:
        np.testing.assert_allclose(got[1].sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_discriminator_q_init_has_the_jax_tree():
    """``DiscriminatorQ``'s own init: the JAX init's keys and shapes, each
    head's tail its own copy of the trunk's last blocks."""
    jtree, jmeta = jax.eval_shape(lambda k: jd.init_discriminator_q(
        k, 16, q_layers=1, n_cat_c=2, n_classes=5, n_cont_c=3), jax.random.PRNGKey(0))
    d = td.DiscriminatorQ(16, q_layers=1, n_cat_c=2, n_classes=5, n_cont_c=3,
                          generator=torch.Generator().manual_seed(0))
    ours = {k: tuple(v.shape) for k, v in convert._flatten(convert.module_tree(d))}
    theirs = {k: tuple(v.shape) for k, v in convert._flatten(jtree)}
    assert ours == theirs
    assert d.meta["q_layers"] == 1 and d.meta["n_classes"] == 5
    assert torch.equal(d.d.blocks[0].conv1.weight, d.q_cat.blocks[0].conv1.weight)
    assert d.d.blocks[0].conv1.weight is not d.q_cat.blocks[0].conv1.weight
    out = d(torch.randn(4, 16, 16, 3), ops=PLAIN)
    assert [tuple(o.shape) for o in out] == [(4, 1), (4, 10), (4, 6)]


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_initialize_params_statistics(init_type):
    params = {"w": torch.ones(3, 3, 32, 16), "b": torch.ones(16),
              "lin": {"weight": torch.ones(256, 64), "bias": torch.ones(64)},
              "wide": [torch.ones(64, 128)]}
    new = initialize_params(params, torch.Generator().manual_seed(0), init_type)
    assert set(new) == set(params) and isinstance(new["wide"], list)
    assert torch.equal(new["b"], torch.zeros(16))
    assert torch.equal(new["lin"]["bias"], torch.zeros(64))
    for w, (fan_in, fan_out) in ((new["w"], (288, 16)), (new["lin"]["weight"], (256, 64)),
                                 (new["wide"][0], (64, 128))):
        assert w.dtype == torch.float32 and not torch.allclose(w, torch.ones_like(w))
        if init_type == "orthogonal":
            q = w.reshape(fan_in, fan_out) / 0.02
            gram = q.T @ q if fan_in >= fan_out else q @ q.T
            np.testing.assert_allclose(gram.numpy(), np.eye(min(fan_in, fan_out)), atol=1e-4)
            continue
        std = {"normal": 0.02, "xavier": 0.02 * math.sqrt(2.0 / (fan_in + fan_out)),
               "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
        assert float(w.std()) == pytest.approx(std, rel=0.05)
        assert abs(float(w.mean())) < 4 * std / math.sqrt(w.numel())
    with pytest.raises(NotImplementedError):
        initialize_params(params, torch.Generator(), "uniform")
