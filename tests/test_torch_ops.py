"""The port's ops (ganecdotes_torch.ops, nn.layers) held against the JAX package.

The same numpy inputs from a seed go through the JAX function and its port;
the JAX side runs on the CPU (Pallas kernels in interpret mode), the port on
its plain CPU path. Tolerances: both sides compute in float32 and differ only
in summation order, so they agree to a few float32 ulps of the largest terms
summed: 1e-5 absolute for elementwise ops and resampling (values O(1)),
2e-5 + 1e-5 relative for convs whose reductions run over 9*Cin terms.

tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.nn import layers as jlayers
from ganecdotes_tpu.ops import fused_act as jfa
from ganecdotes_tpu.ops import interp as jinterp
from ganecdotes_tpu.ops import modulated_conv_pallas as jmc
from ganecdotes_tpu.ops import subpixel_upconv as jsub
from ganecdotes_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas
from ganecdotes_torch.nn import layers as tlayers
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import fused_act as tfa
from ganecdotes_torch.ops import interp as tinterp
from ganecdotes_torch.ops import modulated_conv as tmc
from ganecdotes_torch.ops.opset import OpSet
from ganecdotes_torch.ops import subpixel_upconv as tsub
from ganecdotes_torch.ops import upfirdn2d as tup

# ganecdotes_tpu.ops re-exports a function named upfirdn2d over the module
jup = importlib.import_module("ganecdotes_tpu.ops.upfirdn2d")

ATOL = 1e-5
CONV_TOL = dict(atol=2e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# (a) fused bias + leaky-ReLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 512), (2, 5, 7, 12)])
def test_fused_leaky_relu_matches_jax_and_pallas(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    ours = _np(tfa.fused_leaky_relu(_t(x), _t(b)))
    np.testing.assert_allclose(ours, _np(jfa.fused_leaky_relu(_j(x), _j(b))),
                               atol=ATOL, rtol=0)
    # the Pallas kernel interprets itself off the TPU
    np.testing.assert_allclose(
        ours, _np(jfa.fused_leaky_relu_pallas(_j(x), _j(b))), atol=ATOL, rtol=0)
    no_bias = _np(tfa.fused_leaky_relu(_t(x)))
    np.testing.assert_allclose(no_bias, _np(jfa.fused_leaky_relu(_j(x))),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# (b) upfirdn2d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [(1, 1), (2, 1), (-1, 2, 0, 1)])
def test_upfirdn2d_blur_matches_jax_ref(pad):
    x = np.random.RandomState(1).randn(2, 9, 11, 5).astype(np.float32)
    k = jup.make_kernel((1, 3, 3, 1))
    ours = _np(tup.upfirdn2d(_t(x), tup.make_kernel((1, 3, 3, 1)), pad=pad))
    want = _np(jup.upfirdn2d_ref(_j(x), k, pad=pad))
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)),
                                         ((2, 1), 1, (2, 1, 0, 0))])
def test_upfirdn2d_up_down_matches_jax_ref(up, down, pad):
    x = np.random.RandomState(2).randn(2, 6, 7, 3).astype(np.float32)
    k = jup.make_kernel((1, 3, 3, 1), gain=4.0)
    ours = _np(tup.upfirdn2d(_t(x), k, up=up, down=down, pad=pad))
    want = _np(jup.upfirdn2d_ref(_j(x), k, up=up, down=down, pad=pad))
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("size", [4, 16])
def test_upsample_2d_matches_jax(size):
    """The to_rgb skip upsample (up=2, pad algebra of upsample_2d), C=3."""
    x = np.random.RandomState(3).randn(2, size, size, 3).astype(np.float32)
    ours = _np(tup.upsample_2d(_t(x)))
    want = _np(jup.upfirdn2d_ref(_j(x), jup.make_kernel((1, 3, 3, 1), 4.0),
                                 up=2, pad=(2, 1)))
    assert ours.shape == (2, 2 * size, 2 * size, 3)
    np.testing.assert_allclose(ours, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, _np(jup.upsample_2d(_j(x))), atol=ATOL,
                               rtol=0)


def test_upfirdn2d_blur_matches_pallas_at_128_channels():
    x = np.random.RandomState(4).randn(2, 8, 8, 128).astype(np.float32)
    taps = (0.125, 0.375, 0.375, 0.125)
    ours = _np(tup.upfirdn2d(_t(x), tup.make_kernel((1, 3, 3, 1)), pad=(2, 1)))
    want = _np(upfirdn2d_pallas(_j(x), taps, taps, 1, 1, (2, 1, 2, 1)))
    np.testing.assert_allclose(ours, want, atol=ATOL, rtol=0)


def test_upsample_library_yardstick_is_the_same_function():
    """chip_smoke.py times a depthwise F.conv_transpose2d (stride 2, pad 1)
    as the library call for upsample_2d; it computes the same function."""
    x = _t(np.random.RandomState(5).randn(2, 8, 8, 3))
    k = torch.from_numpy(tup.make_kernel((1, 3, 3, 1), gain=4.0))
    lib = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2), k.expand(3, 1, 4, 4), stride=2, padding=1,
        groups=3).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(lib), _np(tup.upsample_2d(x)), atol=ATOL)


# ---------------------------------------------------------------------------
# nearest resize and NHWC layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((4, 4), (16, 16)), ((5, 3), (12, 7)),
                                     ((8, 8), (8, 8))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.RandomState(6).randn(2, *src, 6).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tinterp.resize_nearest(_t(x), dst)),
        _np(jinterp.resize_nearest(_j(x), dst)))
    for n_in, n_out in [(src[0], dst[0]), (3, 10), (7, 3)]:
        np.testing.assert_array_equal(
            _np(tinterp._nearest_indices(n_in, n_out)),
            jinterp._nearest_indices(n_in, n_out))


def test_layers_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 4) * 0.2).astype(np.float32)
    pairs = [
        (tlayers.pixel_norm(_t(x)), jlayers.pixel_norm(_j(x))),
        (tlayers.leaky_relu(_t(x)), jlayers.leaky_relu(_j(x))),
        (tlayers.conv2d_nhwc(_t(x), _t(w), padding=1),
         jlayers.conv2d_nhwc(_j(x), _j(w), padding=1)),
        (tlayers.conv2d_dilated_nhwc(_t(x), _t(w), dilation=2, padding=2),
         jlayers.conv2d_dilated_nhwc(_j(x), _j(w), dilation=2, padding=2)),
        (tlayers.conv2d_transpose_nhwc(_t(x), _t(w), stride=2),
         jlayers.conv2d_transpose_nhwc(_j(x), _j(w), stride=2)),
    ]
    for ours, want in pairs:
        assert ours.shape == want.shape
        np.testing.assert_allclose(_np(ours), _np(want), **CONV_TOL)


@pytest.mark.parametrize("activation,lr_mul", [(None, 1.0), ("fused_lrelu", 0.01)])
def test_equal_linear_matches_jax(activation, lr_mul):
    rng = np.random.RandomState(8)
    lin = tlayers.EqualLinear(16, 8, bias_init=0.5, lr_mul=lr_mul)
    x = rng.randn(4, 16).astype(np.float32)
    p = {"weight": _j(_np(lin.weight)), "bias": _j(_np(lin.bias))}
    with torch.no_grad():
        ours = _np(lin(_t(x), activation=activation))
    want = _np(jlayers.equal_linear_apply(p, _j(x), lr_mul=lr_mul,
                                          activation=activation))
    np.testing.assert_allclose(ours, want, **CONV_TOL)


# ---------------------------------------------------------------------------
# (c) non-up StyledConv
# ---------------------------------------------------------------------------


def _styled_inputs(B, H, W, Cin, Cout, noise_b, up=False, seed=0):
    rng = np.random.RandomState(seed)
    f = 2 if up else 1
    return [
        rng.randn(B, H, W, Cin).astype(np.float32),
        (rng.randn(3, 3, Cin, Cout) * 0.05).astype(np.float32),
        (rng.rand(B, Cin) + 0.5).astype(np.float32),
        (rng.rand(B, Cout) + 0.5).astype(np.float32),
        rng.randn(noise_b, f * H, f * W, 1).astype(np.float32),
        np.float32(0.3),
        (rng.randn(Cout) * 0.1).astype(np.float32),
    ]


@pytest.mark.parametrize("noise_b", [1, 2])
def test_styled_conv3x3_matches_jax_ref_and_pallas(noise_b):
    """tests/test_ops.py:477-493's shape; noise of batch 1 broadcasts."""
    from jax.experimental.pallas import tpu as pltpu

    args = _styled_inputs(2, 16, 16, 128, 128, noise_b)
    ours = _np(tmc.styled_conv3x3(*[_t(a) for a in args]))
    jargs = [_j(a) for a in args]
    np.testing.assert_allclose(ours, _np(jmc.styled_conv3x3_ref(*jargs)),
                               **CONV_TOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = jmc.styled_conv3x3(*jargs, impl="pallas")
    np.testing.assert_allclose(ours, _np(pallas), **CONV_TOL)


def test_styled_conv3x3_first_layer_shape():
    """The 4x4 conv1 shape (which the JAX kernel refuses) at narrow width."""
    args = _styled_inputs(2, 4, 4, 32, 32, 1, seed=1)
    ours = _np(tmc.styled_conv3x3(*[_t(a) for a in args]))
    np.testing.assert_allclose(
        ours, _np(jmc.styled_conv3x3_ref(*[_j(a) for a in args])), **CONV_TOL)


# ---------------------------------------------------------------------------
# (d) up StyledConv and its weight preparation
# ---------------------------------------------------------------------------


def test_subpixel_weight_prep_matches_jax():
    w = (np.random.RandomState(9).randn(3, 3, 4, 6)).astype(np.float32)
    K = tsub.compose_up_kernel(_t(w))
    np.testing.assert_allclose(_np(K), _np(jsub.compose_up_kernel(_j(w))),
                               atol=ATOL, rtol=0)
    jK = jsub.compose_up_kernel(_j(w))
    np.testing.assert_allclose(_np(tsub.phase_stack(K)),
                               _np(jsub.phase_stack(jK)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tsub.phase_stack_major(K)),
                               _np(jsub.phase_stack_major(jK)), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("noise_b", [1, 2])
def test_styled_up_conv3x3_matches_jax_ref_and_xla(noise_b):
    args = _styled_inputs(2, 8, 8, 32, 48, noise_b, up=True, seed=2)
    targs = [_t(a) for a in args]
    ours = _np(tmc.styled_up_conv3x3(*targs))
    assert ours.shape == (2, 16, 16, 48)
    jargs = [_j(a) for a in args]
    np.testing.assert_allclose(ours, _np(jmc.styled_up_conv3x3_ref(*jargs)),
                               **CONV_TOL)
    np.testing.assert_allclose(ours, _np(jmc.styled_up_conv3x3_xla(*jargs)),
                               **CONV_TOL)
    # the port's own two plain forms agree too
    np.testing.assert_allclose(ours, _np(tmc.styled_up_conv3x3_xla(*targs)),
                               **CONV_TOL)


@pytest.mark.slow
def test_styled_up_conv3x3_matches_jax_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    args = _styled_inputs(2, 8, 8, 128, 256, 2, up=True, seed=3)
    ours = _np(tmc.styled_up_conv3x3(*[_t(a) for a in args]))
    with pltpu.force_tpu_interpret_mode():
        pallas = jmc.styled_up_conv3x3(*[_j(a) for a in args], impl="pallas")
    np.testing.assert_allclose(ours, _np(pallas), **CONV_TOL)


# ---------------------------------------------------------------------------
# wrappers: CPU path never launches; CUDA path checks its inputs
# ---------------------------------------------------------------------------


def test_cpu_wrappers_launch_nothing():
    _build.reset_launches()
    args = [_t(a) for a in _styled_inputs(1, 4, 4, 8, 8, 1)]
    tmc.styled_conv3x3(*args)
    up = [_t(a) for a in _styled_inputs(1, 4, 4, 8, 8, 1, up=True)]
    tmc.styled_up_conv3x3(*up)
    tup.upsample_2d(args[0])
    tfa.fused_leaky_relu(args[0], args[6][:8])
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def test_kernel_build_has_a_source_per_kernel():
    srcs, _ = _build._sources()
    names = {s.rsplit("/", 1)[-1] for s in srcs}
    assert {"fused_act.cu", "upfirdn2d.cu", "styled_conv.cu",
            "sinkhorn.cu"} <= names
    assert set(_build.LAUNCHES) == {"fused_leaky_relu", "upfirdn2d",
                                    "styled_conv3x3", "styled_up_conv3x3",
                                    "sinkhorn_knopp"}
    assert set(_build.LAUNCHES) == set(OpSet._fields)
