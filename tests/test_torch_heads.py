"""The port's heads (selfsup/heads.py): the ``Lin`` head and DatasetGAN's
pixel classifier with its BatchNorm state, held against the JAX package on
the CPU, with the JAX params and state carried across.

Tolerances (float32 on both sides, sums in another order): 1e-5 absolute
plus relative on logits, running stats and gradients of O(1); the folded
eval-mode classifier against the unfolded one 2e-4 absolute, 1e-4 relative
(tests/test_selfsup.py:749's tolerance for the same identity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.selfsup import heads as theads

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _classifier(in_ch=20, n_class=5, seed=0):
    """The JAX classifier's init, with BN stats moved off mean 0 / var 1 so
    an ordering fault in the running update or the fold cannot hide."""
    params, state = jheads.init_pixel_classifier(jax.random.PRNGKey(seed),
                                                 in_ch, n_class)
    state = [{"mean": s["mean"] + 0.3, "var": s["var"] * 1.7,
              "gamma": s["gamma"] * 0.9, "beta": s["beta"] + 0.1}
             for s in state]
    return _np(params), _np(state)


@pytest.mark.parametrize("n_class,widths", [(5, [20, 128, 32, 5]),
                                            (40, [20, 256, 128, 40])])
def test_pixel_classifier_init_widths(n_class, widths):
    params, state = theads.init_pixel_classifier(
        20, n_class, generator=torch.Generator().manual_seed(0))
    jp, js = jheads.init_pixel_classifier(jax.random.PRNGKey(0), 20, n_class)
    assert [tuple(p["weight"].shape) for p in params] == \
        [tuple(p["weight"].shape) for p in jp] == list(zip(widths[:-1], widths[1:]))
    for p in params:  # torch nn.Linear's bound
        bound = 1.0 / p["weight"].shape[0] ** 0.5
        assert p["weight"].abs().max() <= bound and p["bias"].abs().max() <= bound
    for s, j in zip(state, js):
        for k in ("mean", "var", "gamma", "beta"):
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(j[k]))


def test_pixel_classifier_train_mode_and_running_update_match_jax():
    """Two train-mode calls threading the state (batch stats, the unbiased
    running variance at momentum 0.1), then eval mode, and the gradient of
    a train-mode loss with respect to every Linear."""
    params, state = _classifier()
    x = np.random.RandomState(1).randn(2, 5, 6, 20).astype(np.float32)
    tp, ts = from_jax_params(params), from_jax_params(state)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    for _ in range(2):
        jlog, js = jheads.pixel_classifier_apply(jp, js, jnp.asarray(x), train=True)
        tlog, ts = theads.pixel_classifier_apply(tp, ts, torch.from_numpy(x),
                                                 train=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for a, b in zip(js, ts):
            for k in a:
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL)
                assert not b[k].requires_grad
    jlog, _ = jheads.pixel_classifier_apply(jp, js, jnp.asarray(x), train=False)
    tlog, ts2 = theads.pixel_classifier_apply(tp, ts, torch.from_numpy(x),
                                              train=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert ts2 is not None and all(a is b for a, b in zip(ts, ts2))

    def jloss(p):
        return (jheads.pixel_classifier_apply(p, js, jnp.asarray(x),
                                              train=True)[0] ** 2).mean()

    jg = jax.grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for layer in tp for t in layer.values()]
    loss = (theads.pixel_classifier_apply(tp, ts, torch.from_numpy(x),
                                          train=True)[0] ** 2).mean()
    tg = torch.autograd.grad(loss, leaves)
    jleaves = [layer[k] for layer in jg for k in tp[0]]
    for a, b in zip(jleaves, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)


def test_pixel_classifier_from_first_matches_apply_and_jax():
    params, state = _classifier(seed=3)
    x = np.random.RandomState(2).randn(2, 4, 4, 20).astype(np.float32)
    tp, ts = from_jax_params(params), from_jax_params(state)
    want, _ = theads.pixel_classifier_apply(tp, ts, torch.from_numpy(x))
    v1 = torch.from_numpy(x) @ tp[0]["weight"] + tp[0]["bias"]
    got = theads.pixel_classifier_from_first(tp, ts, v1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)
    jv1 = jnp.asarray(x) @ params[0]["weight"] + params[0]["bias"]
    jgot = jheads.pixel_classifier_from_first(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), jv1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)


def test_lin_head_matches_jax():
    seg = _np(jheads.init_one_shot_segmentor(jax.random.PRNGKey(4), 12, 5, "Lin"))
    x = np.random.RandomState(3).randn(2, 6, 7, 12).astype(np.float32)
    want = jheads.one_shot_segmentor_apply(jax.tree.map(jnp.asarray, seg),
                                           jnp.asarray(x), "Lin")
    got = theads.one_shot_segmentor_apply(from_jax_params(seg),
                                          torch.from_numpy(x), "Lin")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy() < 0).any()  # the trailing LeakyReLU keeps negatives
    init = theads.init_one_shot_segmentor(12, 5, "Lin",
                                          generator=torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in init[0].values()] == [(12, 5), (5,)]
    for size in ("XXS", "XS", "S", "Lin"):
        assert theads.segmentor_out_channels(5, size) == \
            jheads.segmentor_out_channels(5, size)


def test_first_conv_hook_is_the_same_head():
    """``first_conv=embed._conv3x3`` (the fine-tune's matmul form of the
    first conv) computes the head that F.conv2d computes, and its gradient."""
    from ganecdotes_torch.selfsup.embed import _conv3x3

    seg = theads.init_one_shot_segmentor(24, 5, "XS",
                                         generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 16, 16, 24, generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for fc in (None, _conv3x3):
        p = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
             for layer in seg]
        y = theads.one_shot_segmentor_apply(p, x, "XS", first_conv=fc)
        outs.append(y.detach())
        grads.append(torch.autograd.grad((y ** 2).sum(), p[0]["weight"])[0])
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[1], grads[0], atol=1e-4, rtol=1e-5)
