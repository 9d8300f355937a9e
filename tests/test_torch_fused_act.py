"""The port's fused bias + leaky-ReLU Functions against the JAX package's
``fused_leaky_relu_pallas`` on the CPU: its Pallas forward in interpret
mode (as the JAX package's own tests run it) and its custom_vjp backward
``_flr_bwd``, differentiated by ``jax.grad`` and ``jax.vjp``.

On a CPU tensor the port's Functions take the plain versions, so these
tests hold the Functions' algebra: the first derivative, the second (R1's
and WGAN-GP's shape: a gradient of a gradient), the VJP of the backward in
its cotangent (the forward with the mask read from y and gdb as the bias)
and the order after it, with and without a bias, at C in {1, 3, 512} (one
channel, an odd count, a discriminator width) and row counts no multiple of
the kernels' row blocks. The kernels themselves are held against these
plain versions on the card (tests/test_torch_gpu.py).

Tolerance: 1e-6 absolute on inputs of unit scale (standard normal, the
bias too), times max(1, max |JAX result|) where a result grows past 1 (the
second derivative's bias gradient sums 21 rows of products and reaches
~400). Both sides compute in float32; they differ in the order of the bias
gradient's sum and, in the second and later derivatives, in where the scale
multiplies (JAX transposes ``where(pos, g, g*slope)*scale`` as
(g*scale)*slope): one or two float32 ulps (6e-8 relative measured), under
1e-6 of the result's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.ops import fused_act as jfa
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import fused_act as tfa

TOL = 1e-6
SLOPE, SCALE = 0.2, float(np.sqrt(2.0))
# (rows as a shape, C): 21 rows at C = 1 (the kernels' block holds 256), 7
# at C = 3 (85 a block), 3 at C = 512 (2 a block)
SHAPES = {1: (3, 7, 1), 3: (7, 3), 512: (3, 512)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch on one thread (a thread pool only adds waits
    when test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed):
    rng = np.random.RandomState(seed)
    shape = SHAPES[c]
    return [rng.randn(*s).astype(np.float32) for s in (shape, (c,), shape, shape)]


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _jax_act(use_bias):
    """The JAX package's kernel with its custom VJP; without a bias it
    takes zeros (and its bias gradient is not compared)."""
    def f(x, b):
        return jfa.fused_leaky_relu_pallas(x, b if use_bias else jnp.zeros_like(b),
                                           SLOPE, SCALE)
    return f


def _port_act(x, b, use_bias):
    return tfa.fused_leaky_relu(x, b if use_bias else None, SLOPE, SCALE)


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("c", [1, 3, 512])
def test_first_derivative_matches_jax(c, use_bias):
    x, b, w, _ = _inputs(c, c)
    f = _jax_act(use_bias)
    want_y = f(jnp.asarray(x), jnp.asarray(b))
    want = jax.grad(lambda x, b: jnp.sum(jnp.asarray(w) * f(x, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(b))
    tx, tb = _t(x, True), _t(b, True)
    y = _port_act(tx, tb, use_bias)
    _close(_np(y), np.asarray(want_y))
    gx, gb = torch.autograd.grad((_t(w) * y).sum(), (tx, tb), allow_unused=True)
    _close(_np(gx), np.asarray(want[0]))
    if use_bias:
        _close(_np(gb), np.asarray(want[1]))
    else:
        assert gb is None


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("c", [1, 3, 512])
def test_second_derivative_matches_jax(c, use_bias):
    """d/d(x, b) of h = ||grad_x L||^2 + <u, grad_b L>, L = <w, f(x, b)^2>:
    the inner gradient's backward runs in the outer one, through y and
    through the backward's cotangent. JAX cannot linearize the Pallas
    forward (``jax.grad`` of ``jax.grad`` fails there), so its side is the
    chain rule written out in ``jax.vjp`` calls of ``fused_leaky_relu_pallas``
    (B, the VJP at (x, b)) and of that VJP in its cotangent (B^T): ct =
    2 w y, (gx, gb) = B(ct), dct = B^T(2 gx, u), dh/d(x, b) = B(2 w dct);
    the mask's own derivative is zero."""
    x, b, w, _ = _inputs(c, 10 + c)
    u = np.random.RandomState(c).randn(c).astype(np.float32)
    f = _jax_act(use_bias)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(b))
    ct = 2 * jnp.asarray(w) * y
    (gx, _), vjp_ct = jax.vjp(vjp, ct)
    (dct,) = vjp_ct((2 * gx, jnp.asarray(u) if use_bias else jnp.zeros(c, jnp.float32)))
    want = vjp(2 * jnp.asarray(w) * dct)

    tx, tb = _t(x, True), _t(b, True)
    inner = (_t(w) * _port_act(tx, tb, use_bias) ** 2).sum()
    gx, gb = torch.autograd.grad(inner, (tx, tb), create_graph=True, allow_unused=True)
    h = gx.square().sum() + ((_t(u) * gb).sum() if use_bias else 0.0)
    hx, hb = torch.autograd.grad(h, (tx, tb), allow_unused=True)
    _close(_np(hx), np.asarray(want[0]))
    if use_bias:
        _close(_np(hb), np.asarray(want[1]))


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("c", [1, 3, 512])
def test_backward_vjp_in_its_cotangent_matches_jax(c, use_bias):
    """The VJP of (dx, db) = backward(g) in g, given (gdx, gdb), and the VJP
    of that in (gdx, gdb): the orders after the second run the same two
    Functions in turn."""
    x, b, g, gdx = _inputs(c, 20 + c)
    rng = np.random.RandomState(c + 1)
    gdb, k = rng.randn(c).astype(np.float32), rng.randn(*g.shape).astype(np.float32)
    f = _jax_act(use_bias)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(b))

    def bwd(g):
        dx, db = vjp(g)
        return dx, (db if use_bias else jnp.zeros_like(db))

    (want_dx, want_db), vjp2 = jax.vjp(bwd, jnp.asarray(g))
    (want_gg,) = vjp2((jnp.asarray(gdx), jnp.asarray(gdb)))
    _, vjp3 = jax.vjp(lambda a, bb: vjp2((a, bb))[0], jnp.asarray(gdx), jnp.asarray(gdb))
    want3 = vjp3(jnp.asarray(k))

    tx, tb = _t(x, True), _t(b, True)
    y = _port_act(tx, tb, use_bias)
    tg = _t(g, True)
    dx, db = torch.autograd.grad(y, (tx, tb), tg, create_graph=True, allow_unused=True)
    _close(_np(dx), np.asarray(want_dx))
    tgdx, tgdb = _t(gdx, True), _t(gdb, True)
    lin = (dx * tgdx).sum() + ((db * tgdb).sum() if use_bias else 0.0)
    (gg,) = torch.autograd.grad(lin, tg, create_graph=True)
    if use_bias:
        _close(_np(db), np.asarray(want_db))
        _close(_np(gg), np.asarray(want_gg))
    else:  # JAX's gdb meets a zero bias gradient: drop it there
        (want_gg,) = vjp2((jnp.asarray(gdx), jnp.zeros(c, jnp.float32)))
        _close(_np(gg), np.asarray(want_gg))
    k3 = torch.autograd.grad((gg * _t(k)).sum(), (tgdx, tgdb), allow_unused=True)
    _close(_np(k3[0]), np.asarray(want3[0]))
    if use_bias:
        _close(_np(k3[1]), np.asarray(want3[1]))
    else:
        assert k3[1] is None


@pytest.mark.parametrize("c", [1, 3, 512])
def test_plain_backward_is_flr_bwd(c):
    """``fused_leaky_relu_bwd_ref`` and the public ``fused_leaky_relu_bwd``
    on CPU tensors: the JAX package's ``_flr_bwd`` on the same y and g,
    dx in its rounded order; no kernel launched."""
    x, b, g, _ = _inputs(c, 30 + c)
    y = np.asarray(jfa.fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b), SLOPE, SCALE))
    want_dx, want_db = jfa._flr_bwd(SLOPE, SCALE, (jnp.asarray(y) >= 0,), jnp.asarray(g))
    _build.reset_launches()
    for fn in (tfa.fused_leaky_relu_bwd_ref, tfa.fused_leaky_relu_bwd):
        dx, db = fn(_t(g), _t(y), True, SLOPE, SCALE)
        np.testing.assert_array_equal(_np(dx), np.asarray(want_dx))
        _close(_np(db), np.asarray(want_db))
        dx2, none = fn(_t(g), _t(y), False, SLOPE, SCALE)
        assert none is None and torch.equal(dx2, dx)
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def test_empty_tensor_and_no_recorded_gradient():
    """An empty input gives empty outputs and a zero bias gradient; without
    a gradient to record the wrapper returns a plain tensor."""
    x = torch.zeros(0, 5, requires_grad=True)
    b = torch.randn(5, requires_grad=True)
    y = tfa.fused_leaky_relu(x, b)
    assert y.shape == (0, 5)
    gx, gb = torch.autograd.grad(y.sum(), (x, b))
    assert gx.shape == (0, 5) and torch.equal(gb, torch.zeros(5))
    with torch.no_grad():
        assert not tfa.fused_leaky_relu(torch.randn(2, 5), b).requires_grad
