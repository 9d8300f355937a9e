"""The port's discriminator (models/stylegan2/discriminator.py), its
EqualConv2d, and the autograd Functions of the kernel wrappers
(fused_leaky_relu, upfirdn2d, the StyledConvs), held against the JAX
package and against finite differences on the CPU.

The discriminator trees are built with numpy at narrow widths (the JAX
``init_discriminator`` is 512 wide up to 32x32, which the forward does not
need): the same tree goes into JAX's ``discriminator_forward`` and, through
``convert.from_jax_discriminator_params``, into the port.

Tolerances: float32 on both sides, sums in another order. Logits and input
gradients (O(1)): 1e-5 absolute + 1e-4 relative; parameter gradients, and
the R1-shaped gradient of a gradient, sum over the whole batch: 1e-4
absolute + 1e-4 relative. gradcheck runs in float64 at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.stylegan2 import discriminator as jd
from ganecdotes_tpu.nn import layers as jlayers
from ganecdotes_torch.models.stylegan2 import convert
from ganecdotes_torch.models.stylegan2 import discriminator as td
from ganecdotes_torch.nn import layers as tlayers
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import fused_act as tfa
from ganecdotes_torch.ops import modulated_conv as tmc
from ganecdotes_torch.ops import upfirdn2d as tup
from ganecdotes_torch.ops.opset import KERNELS, PLAIN

OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


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


def disc_tree(size=16, widths=None, seed=0, in_ch=3):
    """A JAX discriminator params tree (numpy leaves) at narrow widths, with
    nonzero biases."""
    widths = widths or {16: 8, 8: 12, 4: 16}
    rng = np.random.RandomState(seed)

    def conv(k, cin, cout, bias=True):
        p = {"weight": rng.randn(k, k, cin, cout).astype(np.float32)}
        if bias:
            p["bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
        return p

    def lin(cin, cout):
        return {"weight": rng.randn(cin, cout).astype(np.float32),
                "bias": (0.1 * rng.randn(cout)).astype(np.float32)}

    tree = {"conv_in": conv(1, in_ch, widths[size]), "blocks": []}
    c = widths[size]
    r = size
    while r > 4:
        out = widths[r // 2]
        tree["blocks"].append({"conv1": conv(3, c, c), "conv2": conv(3, c, out),
                               "skip": conv(1, c, out, bias=False)})
        c, r = out, r // 2
    c4 = widths[4]
    tree["final_conv"] = conv(3, c4 + 1, c4)
    tree["final_lin1"] = lin(c4 * 16, c4)
    tree["final_lin2"] = lin(c4, 1)
    return tree


def _jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def _images(b=4, size=16, seed=1):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(np.float32)


def test_converted_discriminator_has_the_tree_and_round_trips():
    tree = disc_tree()
    d = convert.from_jax_discriminator_params(tree)
    assert d.meta == jd.discriminator_meta(16)
    back = convert.module_tree(d)
    flat_a = dict(convert._flatten(tree))
    flat_b = dict(convert._flatten(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], _np(flat_b[k]))


@pytest.mark.parametrize("ops", [KERNELS, PLAIN], ids=["kernels", "plain"])
def test_discriminator_forward_matches_jax(ops):
    tree = disc_tree()
    x = _images()
    want = jd.discriminator_forward(_jax_params(tree), jd.discriminator_meta(16),
                                    jnp.asarray(x))
    d = convert.from_jax_discriminator_params(tree)
    ours = td.discriminator_forward(d, _t(x), ops)
    assert ours.shape == (4, 1)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **OUT_TOL)


def test_discriminator_gradients_match_jax():
    """Input and parameter gradients of sum(D(x)), and the parameter
    gradients of ||grad_x sum(D(x))||^2 (R1's gradient of a gradient)."""
    tree = disc_tree(seed=2)
    x = _images(seed=3)
    meta = jd.discriminator_meta(16)

    def j_out(params, xx):
        return jnp.sum(jd.discriminator_forward(params, meta, xx))

    def j_r1(params, xx):
        return jnp.sum(jax.grad(j_out, argnums=1)(params, xx) ** 2)

    jp = _jax_params(tree)
    jg_params, jg_x = jax.jit(jax.grad(j_out, argnums=(0, 1)))(jp, jnp.asarray(x))
    jr1 = jax.jit(jax.grad(j_r1))(jp, jnp.asarray(x))

    d = convert.from_jax_discriminator_params(tree)
    names = [n for n, _ in d.named_parameters()]
    params = list(d.parameters())
    xt = _t(x).requires_grad_(True)
    grads = torch.autograd.grad(td.discriminator_forward(d, xt).sum(), params + [xt])
    np.testing.assert_allclose(_np(grads[-1]), np.asarray(jg_x), **OUT_TOL)
    xt = _t(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(td.discriminator_forward(d, xt).sum(), xt,
                                create_graph=True)
    r1 = torch.autograd.grad(gx.square().sum(), params, allow_unused=True)
    r1 = [torch.zeros_like(p) if g is None else g for p, g in zip(params, r1)]
    jflat = dict(convert._flatten(jax.tree.map(np.asarray, jg_params)))
    jr1flat = dict(convert._flatten(jax.tree.map(np.asarray, jr1)))
    for name, g, g2 in zip(names, grads[:-1], r1):
        np.testing.assert_allclose(_np(g), jflat[name], **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(_np(g2), jr1flat[name], **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("b", [4, 8, 2])
def test_minibatch_stddev_matches_jax(b):
    x = np.random.RandomState(b).randn(b, 4, 4, 6).astype(np.float32)
    np.testing.assert_allclose(_np(td.minibatch_stddev(_t(x))),
                               np.asarray(jd.minibatch_stddev(jnp.asarray(x))),
                               atol=1e-6, rtol=0)


def test_equal_conv2d_matches_jax():
    rng = np.random.RandomState(4)
    p = {"weight": rng.randn(3, 3, 5, 7).astype(np.float32),
         "bias": rng.randn(7).astype(np.float32)}
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    conv = tlayers.EqualConv2d(5, 7, 3)
    conv.load_state_dict({k: _t(v) for k, v in p.items()})
    for stride, pad in ((1, 1), (2, 0)):
        want = jlayers.equal_conv2d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                          stride=stride, padding=pad)
        np.testing.assert_allclose(_np(conv(_t(x), stride=stride, padding=pad)),
                                   np.asarray(want), atol=2e-5, rtol=1e-5)


def test_discriminator_init_is_seeded_and_shaped():
    a = td.Discriminator(16, channel_multiplier=1, generator=torch.Generator().manual_seed(3))
    b = td.Discriminator(16, channel_multiplier=1, generator=torch.Generator().manual_seed(3))
    jtree = jax.eval_shape(lambda k: jd.init_discriminator(k, 16, 1)[0],
                           jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in convert._flatten(jtree)}
    assert shapes == {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert all(torch.equal(u, v) for u, v in zip(a.parameters(), b.parameters()))


def test_cpu_discriminator_launches_nothing():
    d = convert.from_jax_discriminator_params(disc_tree())
    _build.reset_launches()
    xt = _t(_images()).requires_grad_(True)
    (g,) = torch.autograd.grad(d(xt).sum(), xt, create_graph=True)
    g.square().sum().backward()
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


# ---------------------------------------------------------------------------
# the kernel wrappers' autograd Functions, float64 on the CPU
# ---------------------------------------------------------------------------


def _d64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).requires_grad_(True)


def test_fused_leaky_relu_function_gradcheck():
    x, b = _d64(2, 3, 5, seed=1), _d64(5, seed=2)
    assert torch.autograd.gradcheck(tfa.fused_leaky_relu, (x, b))
    assert torch.autograd.gradgradcheck(tfa.fused_leaky_relu, (x, b))
    assert torch.autograd.gradcheck(lambda t: tfa.fused_leaky_relu(t), (x,))


@pytest.mark.parametrize("kw", [dict(pad=(2, 2)), dict(pad=(1, 1)),
                                dict(pad=(-1, 2, 0, 1)), dict(up=2, pad=(2, 1)),
                                dict(up=(2, 1), pad=(2, 1, 0, 0))])
def test_upfirdn2d_function_gradcheck(kw):
    """The blur's backward is the same Function with flipped taps and the
    gradient padding; the up = 2 backward is the plain down-2 FIR; both
    differentiate again."""
    x = _d64(2, 5, 6, 3, seed=3)
    k = np.asarray(tup.make_kernel((1, 3, 3, 1), gain=4.0 if "up" in kw else 1.0),
                   np.float64)
    k = k * (1.0 + 0.1 * np.arange(16).reshape(4, 4))  # asymmetric taps

    def f(t):
        return tup.upfirdn2d(t, k, **kw)

    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))


def _styled64(up, seed=5):
    g = torch.Generator().manual_seed(seed)
    f = 2 if up else 1
    shapes = [(2, 4, 4, 4), (3, 3, 4, 4), (2, 4), (2, 4), (1, 4 * f, 4 * f, 1), (), (4,)]
    args = [torch.randn(s, generator=g, dtype=torch.float64) for s in shapes]
    args[1] = args[1] * 0.3
    args[2] = args[2].abs() + 0.5
    args[3] = args[3].abs() + 0.5
    return [a.requires_grad_(True) for a in args]


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_styled_conv_functions_gradcheck_first_order_only(up):
    """The StyledConv Functions' backward (the VJP of the plain composite)
    against finite differences; a second differentiation raises."""
    args = _styled64(up)
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    assert torch.autograd.gradcheck(fn, tuple(args))
    out = fn(*args)
    (gx,) = torch.autograd.grad(out.square().sum(), args[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|differentiate"):
        torch.autograd.grad(gx.sum(), args[1])


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_styled_conv_function_gradients_match_jax_composite(up):
    """float32 gradients of every input through the Function against JAX's
    VJP of the composite it names."""
    from ganecdotes_tpu.ops import modulated_conv_pallas as jmc

    args64 = _styled64(up, seed=6)
    arrs = [a.detach().numpy().astype(np.float32) for a in args64]
    gout = np.random.RandomState(7).randn(*(2, 8, 8, 4) if up else (2, 4, 4, 4)).astype(np.float32)
    jfn = jmc.styled_up_conv3x3_xla if up else jmc.styled_conv3x3_ref
    _, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrs])
    want = vjp(jnp.asarray(gout))
    ts = [_t(a).requires_grad_(True) for a in arrs]
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    got = torch.autograd.grad(fn(*ts), ts, _t(gout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-5, rtol=1e-5)
