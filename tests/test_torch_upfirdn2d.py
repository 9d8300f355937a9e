"""The port's upfirdn2d (ops/upfirdn2d.py) held against the JAX package.

On a CPU tensor ``upfirdn2d`` is the autograd Function with the plain
version inside; its backward is the same Function with up and down
swapped, the taps flipped and the gradient padding, at every order. The
same numpy inputs go through the port and through the JAX package's
``upfirdn2d_ref``, differentiated by ``jax.vjp`` and ``jax.grad``.

Tolerances: both sides compute in float32 and differ only in summation
order. The outputs (sums of at most 12 x 12 products of O(1) values) and
the first-order gradients agree to 1e-5 absolute; the second-order
gradient ``grad ||grad <w, f(x)^2>||^2`` chains four FIRs and reaches
O(100), so it is held to 1e-5 of its largest element.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas
from ganecdotes_torch.gan import ada
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import upfirdn2d as tup

# ganecdotes_tpu.ops re-exports a function named upfirdn2d over the module
jup = importlib.import_module("ganecdotes_tpu.ops.upfirdn2d")

ATOL = 1e-5
SECOND_RTOL = 1e-5  # of the second-order gradient's largest element

SYM6 = np.asarray(ada.SYM6, np.float32)  # ADA's 12 wavelet taps
AXES = {"1": (1, 1), "up2": (2, 1), "down2": (1, 2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread: these tensors are tiny, and a thread pool
    only adds waits, most of all when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(name):
    """A rank-1 2-D kernel: the 4-tap blur (gain 4) or SYM6 x its reverse."""
    if name == "blur":
        return tup.make_kernel((1, 3, 3, 1), gain=4.0)
    return np.outer(SYM6, SYM6[::-1])


def _torch_grads(x, k, w, **kw):
    """The output, grad <w, f(x)> and grad ||grad <w, f(x)^2>||^2."""
    xt = _t(x).requires_grad_(True)
    y = tup.upfirdn2d(xt, k, **kw)
    (g1,) = torch.autograd.grad((_t(w) * y).sum(), xt)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((_t(w) * tup.upfirdn2d(xt, k, **kw) ** 2).sum(), xt,
                               create_graph=True)
    (g2,) = torch.autograd.grad(g.square().sum(), xt)
    return _np(y), _np(g1), _np(g2)


def _jax_grads(x, k, w, **kw):
    def f(v):
        return jup.upfirdn2d_ref(v, k, **kw)

    xj, wj = jnp.asarray(x), jnp.asarray(w)
    y, vjp = jax.vjp(f, xj)
    (g1,) = vjp(wj)

    def second(v):
        return jnp.sum(jax.grad(lambda u: jnp.sum(wj * f(u) ** 2))(v) ** 2)

    g2 = jax.grad(second)(xj)
    return np.asarray(y), np.asarray(g1), np.asarray(g2)


def _check(ours, want):
    (y, g1, g2), (jy, jg1, jg2) = ours, want
    assert y.shape == jy.shape and g1.shape == jg1.shape
    np.testing.assert_allclose(y, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(g1, jg1, atol=ATOL, rtol=0)
    np.testing.assert_allclose(g2, jg2, atol=SECOND_RTOL * max(1.0, np.abs(jg2).max()),
                               rtol=0)


@pytest.mark.parametrize("ax", AXES)
@pytest.mark.parametrize("ay", AXES)
@pytest.mark.parametrize("taps", ["blur", "sym6"])
def test_upfirdn2d_and_its_gradients_match_jax(ax, ay, taps):
    """Every (up, down) pair the kernel takes, per axis, with 4 and 12 taps
    and a negative pad (a crop) on one side: the output, the first-order
    input gradient and a second-order one (up and down swap in each
    backward)."""
    (ux, dx), (uy, dy) = AXES[ax], AXES[ay]
    k = _kernel(taps)
    kh = k.shape[0]
    kw = dict(up=(ux, uy), down=(dx, dy), pad=(kh // 2, -1, kh // 2 - 1, 1))
    rng = np.random.RandomState(7)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    out = jup.upfirdn2d_ref(jnp.asarray(x), k, **kw)
    w = rng.randn(*out.shape).astype(np.float32)
    _check(_torch_grads(x, k, w, **kw), _jax_grads(x, k, w, **kw))


@pytest.mark.parametrize("case", ["ada_up_x", "ada_down_y", "to_rgb"])
def test_the_paths_one_axis_and_upsample_firs_match_jax(case):
    """ADA's single-axis SYM6 passes (a 1 x 12 and a 12 x 1 kernel) and the
    to_rgb skip upsample (``upsample_2d``, whose backward is a down-2 FIR),
    output and gradients of both orders."""
    k = len(SYM6)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 10, 3).astype(np.float32)
    if case == "ada_up_x":
        kern, kw = SYM6[None, :], dict(up=(2, 1), pad=((k + 1) // 2, (k - 2) // 2, 0, 0))
    elif case == "ada_down_y":
        kern, kw = SYM6[::-1, None].copy(), dict(down=(1, 2), pad=(0, 0, -1, -1))
    else:
        kern, kw = tup.make_kernel((1, 3, 3, 1), 4.0), dict(up=2, pad=(2, 1))
    out = jup.upfirdn2d_ref(jnp.asarray(x), kern, **kw)
    w = rng.randn(*out.shape).astype(np.float32)
    _check(_torch_grads(x, kern, w, **kw), _jax_grads(x, kern, w, **kw))
    if case == "to_rgb":
        np.testing.assert_allclose(_np(tup.upsample_2d(_t(x))), np.asarray(out),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["blur", "sym6", "row", "column", "rank2", "negative"])
def test_separable_taps_match_jax(kernel):
    """The port's copy of the factoring against the JAX package's: the same
    taps (or None for a kernel of rank 2), and the float32 taps the kernel
    receives rebuild the 2-D kernel."""
    k = {
        "blur": tup.make_kernel((1, 3, 3, 1)),
        "sym6": np.outer(SYM6, SYM6),
        "row": SYM6[None, :],
        "column": SYM6[:, None],
        "rank2": np.eye(4, dtype=np.float32) + 0.1,
        "negative": -tup.make_kernel((1, 2, 1)),
    }[kernel]
    ours, want = tup._separable_taps(k), jup._separable_taps(k)
    if want is None:
        assert ours is None and tup.separable_taps(np.asarray(k, np.float32)) is None
        return
    np.testing.assert_allclose(ours[0], want[0], atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours[1], want[1], atol=1e-12, rtol=0)
    ty, tx = tup.separable_taps(np.asarray(k, np.float32))
    assert ty.dtype == tx.dtype == np.float32
    np.testing.assert_allclose(np.outer(ty, tx), k, atol=1e-7, rtol=0)


def test_blur_and_its_gradients_match_pallas_at_128_channels():
    """The blur of the discriminator's shape class against the JAX package's
    Pallas kernel in interpret mode: the output, the first-order gradient
    (its custom VJP, the same kernel with flipped taps) and the second
    order. JAX cannot differentiate the Pallas call again, so the second
    order is composed from the kernel and its VJP: for A = 2 F^T diag(w) F,
    grad ||A x||^2 = 2 A A x."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 128).astype(np.float32)
    taps = (0.125, 0.375, 0.375, 0.125)
    pad = (2, 1)

    def f(v):
        return upfirdn2d_pallas(v, taps, taps, 1, 1, (2, 1, 2, 1))

    y, vjp = jax.vjp(f, jnp.asarray(x))
    w = rng.randn(*y.shape).astype(np.float32)
    wj = jnp.asarray(w)

    def a(v):
        return 2 * jax.vjp(f, v)[1](wj * f(v))[0]

    g1 = vjp(wj)[0]
    g2 = 2 * a(a(jnp.asarray(x)))
    ours = _torch_grads(x, tup.make_kernel((1, 3, 3, 1)), w, pad=pad)
    _check(ours, (np.asarray(y), np.asarray(g1), np.asarray(g2)))


def test_cpu_function_takes_any_case_and_launches_nothing():
    """On the CPU the Function runs the plain version for cases the kernel
    refuses (a kernel of rank 2, 17 taps, up 3) and launches nothing."""
    x = _t(np.random.RandomState(9).randn(1, 6, 6, 2)).requires_grad_(True)
    _build.reset_launches()
    for k, kw in ((np.eye(3, dtype=np.float32), dict(pad=(1, 1))),
                  (np.ones((1, 17), np.float32), dict(pad=(8, 8, 0, 0))),
                  (tup.make_kernel((1, 3, 3, 1)), dict(up=3, pad=(2, 2)))):
        y = tup.upfirdn2d(x, k, **kw)
        np.testing.assert_allclose(_np(y), _np(tup.upfirdn2d_ref(x, k, **kw)), atol=0, rtol=0)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert g.shape == x.shape
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    with pytest.raises(TypeError):
        tup.upfirdn2d(x, torch.ones(4, 4))
    with pytest.raises(ValueError):
        tup.upfirdn2d(x, np.ones(4, np.float32))


def test_downsample_2d_matches_jax_and_takes_impl():
    x = np.random.RandomState(10).randn(2, 10, 12, 3).astype(np.float32)
    want = np.asarray(jup.downsample_2d(jnp.asarray(x)))
    np.testing.assert_allclose(_np(tup.downsample_2d(_t(x))), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tup.downsample_2d(_t(x), impl=tup.upfirdn2d_ref)),
                               want, atol=ATOL, rtol=0)


def test_output_shape_refuses_outputs_over_32_bit_indexing():
    """The kernel indexes in 32 bits and ``_build.check_tensor`` bounds only
    its input: an up-2 FIR of an input under 2**31 elements whose output
    reaches 2**31 is refused before any allocation, and the largest output
    under it is taken."""
    k = tup.make_kernel((1, 3, 3, 1), gain=4.0)
    spec = tup._Spec(k, tup.separable_taps(k), (2, 2), (1, 1), (2, 1, 2, 1))
    shape = (1, 16384, 16384, 2)  # 2**29 elements; the output 2**31
    assert np.prod(shape) < 2**31
    with pytest.raises(ValueError, match="over 2\\*\\*31"):
        tup.output_shape(shape, spec)
    b, oh, ow, c = tup.output_shape((1, 16384, 16383, 2), spec)
    assert (oh, ow) == (32768, 32766) and b * oh * ow * c < 2**31
    with pytest.raises(ValueError, match="empty output"):
        tup.output_shape((1, 1, 1, 2), tup._Spec(k, spec.taps, (1, 1), (1, 1), (-2, -2, 0, 0)))
