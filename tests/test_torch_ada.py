"""The port's ADA (gan/ada.py, ops/affine_warp.py, ops/grid_sample.py,
ops/resample.py) held against the JAX package on the CPU.

The same numpy inputs go through both packages. Random transforms are
passed in: the port's ``augment`` takes JAX's (G, C) matrices. On CPU
tensors the resample wrappers run their plain versions inside their
autograd Functions, so these tests check the Functions' backward rules (each
one's VJP is the other) against JAX autodiff.

Tolerances: the warp pass selects its taps exactly and lerps in float32,
the same arithmetic in both packages, so the passes agree to 1e-6 (values
O(1)); the adjoint sums up to 3*V products per element in another order:
1e-5. A whole augment adds two 12-tap wavelet passes per axis and the 3x3
color matrix: 1e-5 absolute + 1e-5 relative; its gradients (sums over the
whole image) 1e-4 absolute + 1e-4 relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.gan import ada as jada
from ganecdotes_tpu.ops import affine_warp_pallas as jawp
from ganecdotes_tpu.ops.grid_sample import grid_sample_bilinear as j_grid_sample
from ganecdotes_torch.gan import ada as tada
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import affine_warp as taw
from ganecdotes_torch.ops import resample as trs
from ganecdotes_torch.ops.grid_sample import grid_sample_bilinear as t_grid_sample
from ganecdotes_torch.ops.opset import KERNELS, PLAIN

# ganecdotes_tpu.ops re-exports a function named affine_warp over the module
jaw = importlib.import_module("ganecdotes_tpu.ops.affine_warp")

PASS_TOL = dict(atol=1e-6, rtol=0)
ADJ_TOL = dict(atol=1e-5, rtol=0)
AUG_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread: these tensors are tiny, and a thread pool
    only adds waits, most of all when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _pass_inputs(b=2, c=3, s=40, w=36, seed=0, negative=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, s, w).astype(np.float32)
    alpha = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    if negative:
        alpha = -alpha
    # intercepts that run off both ends of [0, S-1], with fractions
    icpt = (rng.rand(b, w) * (s + 10) - 5).astype(np.float32)
    if negative:
        icpt = icpt + 0.8 * s
    return x, alpha, icpt


@jax.jit
def _j_draws(key):
    """JAX ADA draws at p = 1 for B = 3 at 24x24 (the largest case here;
    smaller cases take leading rows): the inverse affine G and color C."""
    k1, k2 = jax.random.split(key)
    return (jnp.linalg.inv(jada.sample_affine(k1, 1.0, 3, 24, 24)),
            jada.sample_color(k2, 1.0, 3))


def _affine_matrices(b, seed=0):
    G, C = _j_draws(jax.random.PRNGKey(seed))
    return np.asarray(G)[:b], np.asarray(C)[:b]


# ---------------------------------------------------------------------------
# the warp pass and its adjoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("negative", [False, True])
def test_resample_pass_matches_jax(axis, negative):
    x, alpha, icpt = _pass_inputs(w=40, negative=negative)
    out_len = 31
    ours = taw._resample_pass(_t(x), _t(alpha), _t(icpt), axis, out_len)
    want = jaw._resample_pass(jnp.asarray(x), jnp.asarray(alpha),
                              jnp.asarray(icpt), axis, out_len)
    assert ours.shape == want.shape
    np.testing.assert_allclose(_np(ours), np.asarray(want), **PASS_TOL)


@pytest.mark.parametrize("negative", [False, True])
def test_resample_rows_match_jax_pallas_interpret(negative):
    """resample_rows and resample_rows_t (kernel wrappers, plain forward on
    the CPU) against the JAX Pallas kernels in interpret mode."""
    x, alpha, icpt = _pass_inputs(negative=negative)
    out_len = 29
    ours = trs.resample_rows(_t(x), _t(alpha), _t(icpt), out_len)
    want = jawp.resample_rows(jnp.asarray(x), jnp.asarray(alpha),
                              jnp.asarray(icpt), out_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **PASS_TOL)
    g = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    ours_t = trs.resample_rows_t(_t(g), _t(alpha), _t(icpt), x.shape[2])
    want_t = jawp.resample_rows_t(jnp.asarray(g), jnp.asarray(alpha),
                                  jnp.asarray(icpt), x.shape[2])
    assert ours_t.shape == x.shape
    np.testing.assert_allclose(_np(ours_t), np.asarray(want_t), **ADJ_TOL)


@pytest.mark.parametrize("negative", [False, True])
def test_resample_adjoint_identity(negative):
    """<A x, g> = <x, A^T g> for the plain pass and its plain adjoint."""
    x, alpha, icpt = _pass_inputs(seed=3, negative=negative)
    x64 = torch.from_numpy(x).double()
    a, ic = _t(alpha), _t(icpt)
    g = torch.randn(2, 3, 33, 36, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    lhs = (trs.resample_rows_ref(x64, a, ic, 33) * g).sum()
    rhs = (x64 * trs.resample_rows_t_ref(g, a, ic, x.shape[2])).sum()
    assert abs(float(lhs - rhs)) <= 1e-10 * max(1.0, abs(float(lhs)))


def test_resample_functions_gradcheck():
    """float64 gradcheck and gradgradcheck of both Functions in the image:
    each one's backward (the other Function) against finite differences."""
    x, alpha, icpt = _pass_inputs(b=1, c=2, s=9, w=7, seed=4)
    a, ic = _t(alpha), _t(icpt)
    xd = torch.from_numpy(x).double().requires_grad_(True)
    gd = torch.randn(1, 2, 6, 7, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: trs.resample_rows(t, a, ic, 6), (xd,))
    assert torch.autograd.gradgradcheck(lambda t: trs.resample_rows(t, a, ic, 6), (xd,))
    assert torch.autograd.gradcheck(lambda t: trs.resample_rows_t(t, a, ic, 9), (gd,))
    assert torch.autograd.gradgradcheck(lambda t: trs.resample_rows_t(t, a, ic, 9), (gd,))


# ---------------------------------------------------------------------------
# the warp
# ---------------------------------------------------------------------------


def _warp_case(seed):
    """A square image and pixel maps from ADA draws at p = 1, one of them
    transposed (|c| > |a|) and one a flip."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 24, 24, 2).astype(np.float32)
    G, _ = _affine_matrices(3, seed=seed)
    M = np.array(jaw.norm_to_pixel_matrix(jnp.asarray(G), (24, 24), (20, 20)))
    M[1] = [[0.1, 1.1, 0.5], [-0.95, 0.2, 20.0]]  # |c| > |a|: transposed
    M[2] = [[-1.0, 0.0, 22.3], [0.0, 1.0, 0.0]]  # flip
    return x, M


def test_norm_to_pixel_matrix_matches_jax():
    G, _ = _affine_matrices(3, seed=2)
    ours = taw.norm_to_pixel_matrix(_t(G), (30, 30), (22, 22))
    want = jaw.norm_to_pixel_matrix(jnp.asarray(G), (30, 30), (22, 22))
    np.testing.assert_allclose(_np(ours), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("impl", ["shear", "shear_pallas", "exact"])
def test_affine_warp_matches_jax(impl):
    """'shear' (plain passes), 'shear_pallas' (the resample op of an op set:
    KERNELS and PLAIN) and 'exact' (the gather) against JAX's 'shear' and
    'exact'."""
    x, M = _warp_case(5)
    want = jax.jit(jaw.affine_warp, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(M), (20, 20), "exact" if impl == "exact" else "shear")
    # the gather's source coordinates come out of an einsum whose rounding
    # differs between the packages: 1e-5 there
    tol = AUG_TOL if impl == "exact" else PASS_TOL
    for ops in (KERNELS, PLAIN):
        ours = taw.affine_warp(_t(x), _t(M), (20, 20), impl=impl, ops=ops)
        np.testing.assert_allclose(_np(ours), np.asarray(want), **tol)


def test_grid_sample_matches_jax_and_torch():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    grid = (rng.rand(2, 5, 6, 2) * 2.4 - 1.2).astype(np.float32)
    ours = t_grid_sample(_t(x), _t(grid))
    np.testing.assert_allclose(_np(ours), np.asarray(j_grid_sample(
        jnp.asarray(x), jnp.asarray(grid))), atol=1e-6, rtol=0)
    lib = torch.nn.functional.grid_sample(
        _t(x).permute(0, 3, 1, 2), _t(grid), mode="bilinear",
        padding_mode="zeros", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(ours), _np(lib), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------


def test_transform_matrices_match_jax():
    rng = np.random.RandomState(7)
    a, b = rng.randn(4).astype(np.float32), rng.rand(4).astype(np.float32)
    axis = (3**-0.5,) * 3
    pairs = [
        (tada.translate_mat(_t(a), _t(b)), jada.translate_mat(a, b)),
        (tada.rotate_mat(_t(a)), jada.rotate_mat(a)),
        (tada.scale_mat(_t(a), _t(b)), jada.scale_mat(a, b)),
        (tada.translate3d_mat(_t(a), _t(b), _t(a)), jada.translate3d_mat(a, b, a)),
        (tada.scale3d_mat(_t(a), _t(b), _t(b)), jada.scale3d_mat(a, b, b)),
        (tada.rotate3d_mat(axis, _t(a)), jada.rotate3d_mat(axis, a)),
        (tada.luma_flip_mat(axis, _t(b)), jada.luma_flip_mat(axis, b)),
        (tada.saturation_mat(axis, _t(b)), jada.saturation_mat(axis, b)),
    ]
    for ours, want in pairs:
        np.testing.assert_allclose(_np(ours), np.asarray(want), atol=1e-6, rtol=0)


def test_sampled_transforms_are_identity_at_p0_and_valid_at_p1():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tada.sample_affine(g, 0.0, 5, 16, 16), torch.eye(3).repeat(5, 1, 1))
    assert torch.equal(tada.sample_color(g, 0.0, 5), torch.eye(4).repeat(5, 1, 1))
    G = tada.sample_affine(g, 1.0, 64, 16, 16)
    assert not torch.allclose(G, torch.eye(3).repeat(64, 1, 1))
    assert torch.equal(G[:, 2], torch.tensor([0.0, 0.0, 1.0]).expand(64, 3))
    # flips, rotations and isotropic/anisotropic scales: |det| = iso scale^2
    assert bool(torch.isfinite(G).all()) and bool((torch.linalg.det(G).abs() > 0.05).all())
    C = tada.sample_color(g, 1.0, 64)
    assert torch.equal(C[:, 3, :3], torch.zeros(64, 3))
    assert not torch.allclose(C, torch.eye(4).repeat(64, 1, 1))


@jax.jit
def _j_augment(img, G, C):
    """JAX augment with its matrices passed in (jitted: one compile costs
    less than eager dispatch of every op)."""
    return jada.augment(img, 1.0, jax.random.PRNGKey(0), transform_matrix=(G, C))[0]


def _augment_pair(seed=8, b=2, size=16):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, size, size, 3).astype(np.float32)
    G, C = _affine_matrices(b, seed=seed)
    return img, G, C


@pytest.mark.parametrize("ops", [KERNELS, PLAIN], ids=["kernels", "plain"])
def test_augment_matches_jax(ops):
    img, G, C = _augment_pair()
    want = _j_augment(jnp.asarray(img), jnp.asarray(G), jnp.asarray(C))
    ours, (oG, oC) = tada.augment(_t(img), transform_matrix=(_t(G), _t(C)), ops=ops)
    assert ours.shape == want.shape == img.shape
    np.testing.assert_allclose(_np(ours), np.asarray(want), **AUG_TOL)
    np.testing.assert_array_equal(_np(oG), G)


@jax.jit
def _j_affine(img, G):
    return jada.random_apply_affine(img, 1.0, jax.random.PRNGKey(0), G=G)[0]


@pytest.mark.parametrize("ops", [KERNELS, PLAIN], ids=["kernels", "plain"])
def test_random_apply_affine_matches_jax(ops):
    """The geometric part alone, with the JAX G passed in: the four SYM6
    wavelet passes run through ``ops.upfirdn2d`` (the FIR Function with
    ``KERNELS``, ``upfirdn2d_ref`` with ``PLAIN``) and the warp through
    ``ops.resample_rows`` (the shear warp takes square images)."""
    rng = np.random.RandomState(12)
    img = rng.randn(2, 20, 20, 3).astype(np.float32)
    G, _ = _affine_matrices(2, seed=12)
    want = _j_affine(jnp.asarray(img), jnp.asarray(G))
    ours, oG = tada.random_apply_affine(_t(img), G=_t(G), ops=ops)
    assert ours.shape == want.shape == img.shape
    np.testing.assert_allclose(_np(ours), np.asarray(want), **AUG_TOL)
    np.testing.assert_array_equal(_np(oG), G)


@pytest.mark.parametrize("shape,pad", [((2, 9, 7, 3), (5, 6)), ((1, 13, 6, 2), (12, 1))],
                         ids=["9x7", "13x6"])
def test_reflect_pad_matches_f_pad_and_jax(shape, pad):
    """``reflect_pad`` (slices, flips, ``torch.cat``) against ``F.pad(mode=
    "reflect")``: the forward bit for bit; the gradient of <w, pad(x)>
    against F.pad's and against the VJP of JAX's ``jnp.pad(mode="reflect")``
    (ganecdotes_tpu/gan/ada.py:260), within 1e-6 relative: the sums of up to
    nine reflected cotangents may be taken in another order."""
    py, px = pad
    rng = np.random.RandomState(sum(shape))
    img = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[0], shape[1] + 2 * py, shape[2] + 2 * px, shape[3]).astype(np.float32)

    def f_pad(x):
        return torch.nn.functional.pad(x.permute(0, 3, 1, 2), [px, px, py, py],
                                       mode="reflect").permute(0, 2, 3, 1)

    x = _t(img).requires_grad_(True)
    ours = tada.reflect_pad(x, py, px)
    assert torch.equal(ours, f_pad(_t(img)))
    (g,) = torch.autograd.grad((ours * _t(w)).sum(), x)
    x = _t(img).requires_grad_(True)
    (g_f,) = torch.autograd.grad((f_pad(x) * _t(w)).sum(), x)
    _, vjp = jax.vjp(lambda a: jnp.pad(a, ((0, 0), (py, py), (px, px), (0, 0)),
                                       mode="reflect"), jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(w))
    for want in (_np(g_f), np.asarray(g_j)):
        np.testing.assert_allclose(_np(g), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="smaller than the axis"):
        tada.reflect_pad(_t(img), shape[1], px)


def test_augment_gradients_match_jax():
    """First and second order through augment: grad of <w, aug(x)> and the
    gradient of ||grad_x <w, aug(x)^2>||^2 (the R1 shape: a gradient of a
    gradient through both resample Functions)."""
    img, G, C = _augment_pair(seed=9)
    w = np.random.RandomState(10).randn(*img.shape).astype(np.float32)
    jG, jC, jw = jnp.asarray(G), jnp.asarray(C), jnp.asarray(w)

    def j_second(x):
        g = jax.grad(lambda y: jnp.sum(jw * _j_augment(y, jG, jC) ** 2))(x)
        return jnp.sum(g**2)

    j1 = jax.jit(jax.grad(lambda x: jnp.sum(jw * _j_augment(x, jG, jC))))(jnp.asarray(img))
    j2 = jax.jit(jax.grad(j_second))(jnp.asarray(img))

    def t_aug(x):
        return tada.augment(x, transform_matrix=(_t(G), _t(C)), ops=KERNELS)[0]

    x = _t(img).requires_grad_(True)
    (t1,) = torch.autograd.grad((_t(w) * t_aug(x)).sum(), x)
    x = _t(img).requires_grad_(True)
    (g,) = torch.autograd.grad((_t(w) * t_aug(x) ** 2).sum(), x, create_graph=True)
    (t2,) = torch.autograd.grad(g.square().sum(), x)
    np.testing.assert_allclose(_np(t1), np.asarray(j1), **GRAD_TOL)
    np.testing.assert_allclose(_np(t2), np.asarray(j2), **GRAD_TOL)


def test_augment_cpu_launches_nothing():
    img, G, C = _augment_pair()
    _build.reset_launches()
    tada.augment(_t(img), transform_matrix=(_t(G), _t(C)))
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


# ---------------------------------------------------------------------------
# the adaptive-p controller
# ---------------------------------------------------------------------------


def test_ada_update_sequence_matches_jax():
    rng = np.random.RandomState(11)
    js, ts = jada.ada_init_state(0.1), tada.ada_init_state(0.1)
    for i in range(13):
        pred = (rng.randn(6, 1) + (0.8 if i < 7 else -0.5)).astype(np.float32)
        js = jada.ada_update(js, jnp.asarray(pred), 0.6, 50, 4)
        ts = tada.ada_update(ts, _t(pred), 0.6, 50, 4)
        for k in ("buf", "p", "r_t"):
            np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), atol=1e-6, rtol=0)
        assert int(ts["update"]) == int(js["update"])
        assert ts["update"].dtype == torch.int32


def test_adaptive_augment_class_matches_jax():
    ja = jada.AdaptiveAugment(0.6, 40, 2)
    ta = tada.AdaptiveAugment(0.6, 40, 2)
    rng = np.random.RandomState(12)
    for _ in range(6):
        pred = rng.randn(5, 1).astype(np.float32) + 0.3
        assert ta.tune(_t(pred)) == pytest.approx(ja.tune(pred), abs=1e-6)
    assert ta.r_t_stat == pytest.approx(ja.r_t_stat, abs=1e-6)
