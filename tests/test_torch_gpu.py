"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device: it is marked ``gpu`` and its fixture
skips without one. The file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed, without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: kernel and plain version both compute in float32 (TF32 off)
and differ only in summation order. The convs sum 9*Cin = 4608 terms into
outputs of magnitude up to ~10, where a few float32 ulps are ~1e-5 to 3e-5
(2.2e-5 measured on an H100): 1e-4 absolute + 1e-5 relative. Resampling
and elementwise ops: 1e-5 absolute. Sinkhorn codes in [0, 1]: 1e-4
absolute, the JAX package's tolerance for an online-max log-sum-exp against
the two-pass one (tests/test_selfsup.py:191-195), and 0.1/K, a tenth of the
mean code (each row sums to 1 over K).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops import fused_act as tfa
from ganecdotes_torch.ops import modulated_conv as tmc
from ganecdotes_torch.ops import sinkhorn as tsk
from ganecdotes_torch.ops import upfirdn2d as tup
from ganecdotes_torch.ops.opset import PLAIN

ATOL = 1e-5
CONV_TOL = dict(atol=1e-4, rtol=1e-5)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ganecdotes_torch import resolve_device

    return resolve_device("cuda")


def _styled_inputs(B, H, W, Cin, Cout, noise_b, up, dev, seed=0):
    rng = np.random.RandomState(seed)
    f = 2 if up else 1
    arrs = [
        rng.randn(B, H, W, Cin),
        rng.randn(3, 3, Cin, Cout) * 0.05,
        rng.rand(B, Cin) + 0.5,
        rng.rand(B, Cout) + 0.5,
        rng.randn(noise_b, f * H, f * W, 1),
        np.float32(0.3),
        rng.randn(Cout) * 0.1,
    ]
    return [torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("shape", [(8, 4, 4, 512, 512), (2, 16, 16, 128, 128),
                                   (3, 5, 7, 36, 20), (1, 9, 3, 4, 132),
                                   (2, 32, 32, 512, 256), (3, 13, 6, 40, 136),
                                   (1, 4, 4, 512, 512), (20, 4, 4, 512, 512),
                                   (8, 8, 8, 512, 512), (20, 7, 5, 64, 4),
                                   (1, 11, 9, 32, 100), (8, 16, 16, 512, 124),
                                   (20, 8, 8, 512, 512), (4, 72, 72, 32, 64)])
@pytest.mark.parametrize("noise_b", ["one", "batch"])
def test_styled_convs_match_plain(cuda, shape, noise_b):
    """The ffhq first up layer, a pidray-like 32 -> 64 layer, and ragged
    shapes: (3, 13, 6, 40, 136) leaves every phase class of the up GEMM
    with a partial last tile in M (3*14*7 = 294 rows, ...), in N (136) and
    in K (40 channels). The non-up kernel (9-tap GEMM in 3xTF32, epilogue
    in registers) also at B = 1 (the SwAV generator), 8 (a serving request)
    and 20 (the GAN batch): the 4x4 first layer with Cin = 512 (K = 4608,
    1 to 20 row tiles), and ragged M and Cout (4 <= Cout < 128; 20*7*5 = 700
    and 11*9 = 99 rows). Its taps split 9 ways (most small grids), 3 ways
    (8x8 at B = 20) or not at all (4 * 72 * 72 rows: 162 tiles)."""
    B, H, W, Ci, Co = shape
    nb = 1 if noise_b == "one" else B
    before = dict(_build.LAUNCHES)
    a = _styled_inputs(B, H, W, Ci, Co, nb, False, cuda)
    torch.testing.assert_close(tmc.styled_conv3x3(*a),
                               tmc.styled_conv3x3_ref(*a), **CONV_TOL)
    a = _styled_inputs(B, H, W, Ci, Co, nb, True, cuda)
    out = tmc.styled_up_conv3x3(*a)
    torch.testing.assert_close(out, tmc.styled_up_conv3x3_ref(*a), **CONV_TOL)
    torch.testing.assert_close(out, tmc.styled_up_conv3x3_xla(*a), **CONV_TOL)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["styled_conv3x3"] == before["styled_conv3x3"] + 1
    assert _build.LAUNCHES["styled_up_conv3x3"] == before["styled_up_conv3x3"] + 1


@pytest.mark.parametrize("kw", [dict(up=2, pad=(2, 1)), dict(pad=(1, 1)),
                                dict(pad=(-1, 2, 0, 1)), dict(up=2, pad=(1, -1)),
                                dict(up=(2, 1), pad=(2, 1, 0, 0))])
def test_upfirdn2d_matches_plain(cuda, kw):
    x = torch.randn(2, 9, 11, 5, generator=torch.Generator().manual_seed(0)).to(cuda)
    k = tup.make_kernel((1, 3, 3, 1), gain=4.0)
    torch.testing.assert_close(tup.upfirdn2d(x, k, **kw),
                               tup.upfirdn2d_ref(x, k, **kw), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(8, 512), (3, 7, 6), (5, 3)])
def test_fused_leaky_relu_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g).to(cuda)
    b = torch.randn(shape[-1], generator=g).to(cuda)
    torch.testing.assert_close(tfa.fused_leaky_relu(x, b),
                               tfa.fused_leaky_relu_ref(x, b), atol=ATOL, rtol=0)
    torch.testing.assert_close(tfa.fused_leaky_relu(x),
                               tfa.fused_leaky_relu_ref(x), atol=ATOL, rtol=0)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        tfa.fused_leaky_relu(x.double())
    with pytest.raises(ValueError):
        tfa.fused_leaky_relu(x.transpose(1, 2))
    with pytest.raises(ValueError):
        tup.upfirdn2d(x, np.ones((9, 9), np.float32))
    with pytest.raises(TypeError):
        tup.upfirdn2d(x, torch.ones(4, 4, device=cuda))
    k = tup.make_kernel((1, 3, 3, 1))
    with pytest.raises(ValueError):  # no path subsamples: down is 1
        tup.upfirdn2d(x, k, down=2, pad=(1, 1))
    with pytest.raises(ValueError):
        tup.upfirdn2d(x, k, up=3, pad=(2, 1))
    a = _styled_inputs(2, 4, 4, 6, 8, 1, False, cuda)  # Cin % 4 != 0
    with pytest.raises(ValueError):
        tmc.styled_conv3x3(*a)
    a = _styled_inputs(2, 4, 4, 8, 8, 1, False, cuda)
    with pytest.raises(ValueError):  # noise on the wrong grid
        tmc.styled_conv3x3(*a[:4], a[4][:, :2], *a[5:])


def test_server_kernels_match_plain_ops(cuda):
    from ganecdotes_torch.pipeline.serving import OneShotServer

    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=256,
                         gen_args=dict(size=64, style_dim=512, n_mlp=8),
                         classes=["c%d" % i for i in range(8)])
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(hlen=1300, nclasses=16, nprototypes=32,
                                          projn_nw="linear", hf_interp="nearest")),
        seg_args=dict(size="XXS", in_ch=16))
    _build.reset_launches()
    server = OneShotServer(mc, sc, device=cuda, seed=1)
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(2))
    img, labels, z0 = server.serve(z)
    torch.cuda.synchronize()
    serving = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
               "styled_up_conv3x3")
    assert all(_build.LAUNCHES[k] > 0 for k in serving), _build.LAUNCHES
    # the plain server draws its own mean latent from the same seed
    plain = OneShotServer(mc, sc, device=cuda, seed=1, gen=server.gen,
                          ssl_params=server.ssl_params,
                          seg_params=server.seg_params, ops=PLAIN)
    torch.testing.assert_close(server.mean_latent, plain.mean_latent,
                               atol=ATOL, rtol=0)
    p_img, p_labels, p_z0 = plain.serve(z)
    torch.testing.assert_close(img, p_img, atol=2e-4, rtol=1e-4)
    assert (labels == p_labels).float().mean().item() >= 0.999
    assert (z0 == p_z0).float().mean().item() >= 0.999


@pytest.mark.parametrize("b,k,niters,eps", [
    (64, 128, 10, 0.005), (1999, 1237, 3, 0.05), (300, 256, 0, 0.05),
    (130, 7, 2, 0.5), (20000, 5000, 10, 0.05), (4000, 8000, 3, 0.05),
    (2003, 5001, 1, 0.05), (997, 8000, 0, 0.05), (257, 8192, 1, 0.05)])
def test_sinkhorn_matches_plain(cuda, b, k, niters, eps):
    """Small, ragged (B and K no multiple of any tile; K % 4 != 0 takes the
    scalar loads), niters = 0 and 1, K below one warp's width, the shipped
    K = 5000 (at the path's (20000, 5000)) and the generic 8000, and the
    largest K the kernel takes. Two launches give equal bits."""
    g = torch.Generator().manual_seed(b + k)
    scores = torch.randn(b, k, generator=g).to(cuda)
    r = torch.rand(k, generator=g) + 0.1
    c = torch.rand(b, generator=g) + 0.1
    r, c = (r / r.sum()).to(cuda), (c / c.sum()).to(cuda)
    before = _build.LAUNCHES["sinkhorn_knopp"]
    q = tsk.sinkhorn_knopp(scores, niters, eps, r, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sinkhorn_knopp"] == before + 1
    want = tsk.sinkhorn_knopp_ref(scores, niters, eps, r, c)
    torch.testing.assert_close(q, want, atol=1e-4, rtol=0)
    # and scaled to the codes, whose rows sum to 1: a tenth of the mean 1/K
    assert (q - want).abs().max().item() <= 0.1 / k
    # deterministic: no atomics, the chunks merged in a fixed order
    assert torch.equal(tsk.sinkhorn_knopp(scores, niters, eps, r, c), q)


def test_sinkhorn_refuses_what_it_does_not_take(cuda):
    x = torch.randn(16, 8, device=cuda)
    r, c = torch.ones(8, device=cuda) / 8, torch.ones(16, device=cuda) / 16
    with pytest.raises(TypeError):
        tsk.sinkhorn_knopp(x.double(), 2, 0.1, r, c)
    with pytest.raises(ValueError):
        tsk.sinkhorn_knopp(torch.randn(8, 16, device=cuda).T, 2, 0.1, r, c)
    with pytest.raises(ValueError):
        tsk.sinkhorn_knopp(x, 2, 0.1, c, r)
    with pytest.raises(ValueError):
        tsk.sinkhorn_knopp(x, 2, 0.1, r.cpu(), c)
    k = tsk.MAX_K + 4
    with pytest.raises(ValueError, match=f"at most {tsk.MAX_K}"):
        tsk.sinkhorn_knopp(torch.randn(16, k, device=cuda), 2, 0.1,
                           torch.ones(k, device=cuda) / k, c)


def test_swav_pretrain_kernels_match_plain_ops(cuda):
    """Two SwAV steps at size 32 with KERNELS and with PLAIN from the same
    seed: the same draws, the Sinkhorn kernel launched 2 x num_patches times
    per step, and losses and params that agree."""
    from ganecdotes_torch.models.stylegan2.generator import Generator
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.selfsup.lars import tree_leaves
    from ganecdotes_torch.selfsup.swav import SwAVClustering

    mc = SimpleNamespace(truncation=0.7, latent_dim=512, image_size=32,
                         num_latents_for_mean=256)
    pa = dict(truncation=0.7, n_layers=3, n_samples=1, layer_no=None,
              perturb_std=[1.0] * 3)
    sa = dict(num_epochs=2, num_samples=1, num_patches=2, patch_size=200,
              sampling_method="random", hf_interp="nearest", use_scheduler=False,
              trust_coeff=0.01, train_args=dict(lr=0.01, momentum=0.9),
              projn_nw="linear", temperature=0.01, nprototypes=300,
              nclasses=16, hlen=1300, add_local_loss=False, epoch_print_freq=1)
    sk = dict(source_pdf="uniform", niters=10, eps=0.005)
    gen = Generator(32, generator=torch.Generator().manual_seed(0))
    runs = []
    for ops in (KERNELS, PLAIN):
        _build.reset_launches()
        swav = SwAVClustering(gen, mc, pa, sa, sk, device=cuda, seed=5, ops=ops)
        swav.record_loss_history = True
        swav.pretrain()
        torch.cuda.synchronize()
        runs.append((swav, dict(_build.LAUNCHES)))
    (kern, launches), (plain, plain_launches) = runs
    assert launches["sinkhorn_knopp"] == 2 * 2 * 2, launches
    path = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
            "styled_up_conv3x3", "sinkhorn_knopp")
    assert all(launches[k] > 0 for k in path), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    np.testing.assert_allclose(kern.loss_history, plain.loss_history, rtol=1e-4)
    for a, b in zip(tree_leaves(kern.ssl_params), tree_leaves(plain.ssl_params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the BagGAN slice: ADA's warp pass, the Functions' gradients, one iteration
# ---------------------------------------------------------------------------


def _pass_case(b, c, s, w, v, negative, dev, seed=0, alpha=None):
    """A pass with alpha in [0.7, 1.3] (negated where ``negative``), or the
    given ``alpha`` for every image, and intercepts that run off both ends
    of the source column."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, s, w, generator=g)
    a = torch.rand(b, generator=g) * 0.6 + 0.7
    if alpha is not None:
        a = torch.full((b,), float(alpha))
    icpt = torch.rand(b, w, generator=g) * (s + 10) - 5
    if negative:
        a, icpt = -a, icpt + 0.8 * s
    return x.to(dev), a.to(dev), icpt.to(dev), v


@pytest.mark.parametrize("shape", [(2, 3, 40, 36, 29), (3, 1, 101, 77, 59),
                                   (1, 2, 9, 300, 120)])
@pytest.mark.parametrize("negative,alpha", [(False, None), (True, None),
                                            (False, 0.0), (False, 0.05),
                                            (True, 0.05), (True, 1e-40)],
                         ids=["pos", "neg", "zero", "small", "small_neg",
                              "subnormal_neg"])
def test_resample_kernels_match_plain(cuda, shape, negative, alpha):
    """Small, ragged (W and V no multiple of a warp) and flipped (alpha < 0)
    passes, and alpha = 0, |alpha| = 0.05 and a subnormal alpha, whose
    1/alpha overflows (the adjoint's widest candidate windows): the forward
    kernel equals the plain pass (same rounded steps), the adjoint agrees to
    1e-5 * max(1, max |plain|) and repeats bit for bit (no atomics). The
    adjoint's scale matters at alpha = 0: every output row folds onto the
    same source rows, so each element sums all V products and reaches tens,
    where two float32 summation orders differ by a few ulps (a 1e-5
    absolute check failed there for some draws of g)."""
    from ganecdotes_torch.ops import resample as trs

    x, alpha, icpt, v = _pass_case(*shape, negative, cuda, alpha=alpha)
    before = dict(_build.LAUNCHES)
    out = trs.resample_rows(x, alpha, icpt, v)
    torch.testing.assert_close(out, trs.resample_rows_ref(x, alpha, icpt, v),
                               atol=ATOL, rtol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    dx = trs.resample_rows_t(g, alpha, icpt, x.shape[2])
    want = trs.resample_rows_t_ref(g, alpha, icpt, x.shape[2])
    torch.testing.assert_close(dx, want, rtol=0,
                               atol=ATOL * max(1.0, want.abs().max().item()))
    torch.testing.assert_close(trs.resample_rows_t(g, alpha, icpt, x.shape[2]), dx,
                               atol=0, rtol=0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["resample_rows"] == before["resample_rows"] + 1
    assert _build.LAUNCHES["resample_rows_t"] == before["resample_rows_t"] + 2
    # the adjoint identity <A x, g> = <x, A^T g>, summed in float64
    lhs = (out.double() * g.double()).sum()
    rhs = (x.double() * dx.double()).sum()
    scale = out.double().norm() * g.double().norm()
    assert abs(float(lhs - rhs)) <= 1e-5 * float(scale)


def test_resample_adjoint_repeats_bit_for_bit(cuda):
    """Two launches of the adjoint at ADA's pass V width (one image) give
    equal bits: each element is one thread's sum in increasing v."""
    from ganecdotes_torch.ops import resample as trs

    _, alpha, icpt, v = _pass_case(2, 3, 792, 792, 524, True, cuda, seed=4)
    g = torch.randn(2, 3, v, 792, generator=torch.Generator().manual_seed(5)).to(cuda)
    first = trs.resample_rows_t(g, alpha, icpt, 792)
    second = trs.resample_rows_t(g, alpha, icpt, 792)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _second_order(fn, x, w):
    """grad_x of ||grad_x <w, fn(x)^2>||^2: two backward passes."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((w * fn(x) ** 2).sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    return gg


def test_double_grad_through_kernels_matches_plain(cuda):
    """R1's shape of derivative through the resample, blur and fused
    Functions (kernels in both backward passes) against plain autograd."""
    from ganecdotes_torch.ops import resample as trs

    x, alpha, icpt, v = _pass_case(2, 3, 40, 36, 29, False, cuda, seed=1)
    w = torch.randn(2, 3, v, 36, device=cuda)
    before = dict(_build.LAUNCHES)
    got = _second_order(lambda t: trs.resample_rows(t, alpha, icpt, v), x, w)
    want = _second_order(lambda t: trs.resample_rows_ref(t, alpha, icpt, v), x, w)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert _build.LAUNCHES["resample_rows_t"] > before["resample_rows_t"]
    assert _build.LAUNCHES["resample_rows"] > before["resample_rows"] + 1

    xb = torch.randn(2, 9, 11, 8, device=cuda)
    wb = torch.randn(2, 10, 12, 8, device=cuda)
    k = tup.make_kernel((1, 3, 3, 1))
    got = _second_order(lambda t: tup.upfirdn2d(t, k, pad=(2, 2)), xb, wb)
    want = _second_order(lambda t: tup.upfirdn2d_ref(t, k, pad=(2, 2)), xb, wb)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)

    xf = torch.randn(4, 6, 8, device=cuda)
    bias = torch.randn(8, device=cuda)
    got = _second_order(lambda t: tfa.fused_leaky_relu(t, bias), xf, xf.cos())
    want = _second_order(lambda t: tfa.fused_leaky_relu_ref(t, bias), xf, xf.cos())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_styled_conv_function_grads_match_plain(cuda, up):
    a = _styled_inputs(2, 8, 8, 64, 32, 1, up, cuda, seed=3)
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    ref = tmc.styled_up_conv3x3_xla if up else tmc.styled_conv3x3_ref
    ins = [t.clone().requires_grad_(True) for t in a]
    out = fn(*ins)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, ins, g)
    ins_ref = [t.clone().requires_grad_(True) for t in a]
    want = torch.autograd.grad(ref(*ins_ref), ins_ref, g)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, **CONV_TOL)


def test_kernel_outputs_carry_the_graph(cuda):
    """No detached kernel outputs: every wrapper that launches a kernel
    returns a tensor autograd can follow, or refuses an input that needs a
    gradient (the Sinkhorn, whose codes are constants)."""
    from ganecdotes_torch.ops import resample as trs

    x = torch.randn(2, 4, 4, 8, device=cuda, requires_grad=True)
    bias = torch.zeros(8, device=cuda, requires_grad=True)
    assert tfa.fused_leaky_relu(x, bias).requires_grad
    assert tup.upfirdn2d(x, tup.make_kernel((1, 3, 3, 1)), pad=(2, 1)).requires_grad
    a = [t.requires_grad_(True) for t in _styled_inputs(2, 4, 4, 8, 8, 1, False, cuda)]
    assert tmc.styled_conv3x3(*a).requires_grad
    a = [t.requires_grad_(True) for t in _styled_inputs(2, 4, 4, 8, 8, 1, True, cuda)]
    assert tmc.styled_up_conv3x3(*a).requires_grad
    xr, alpha, icpt, v = _pass_case(1, 1, 9, 7, 5, False, cuda)
    xr.requires_grad_(True)
    assert trs.resample_rows(xr, alpha, icpt, v).requires_grad
    assert trs.resample_rows_t(xr, alpha, icpt, 11).requires_grad
    scores = torch.randn(16, 8, device=cuda, requires_grad=True)
    r, c = torch.ones(8, device=cuda) / 8, torch.ones(16, device=cuda) / 16
    with pytest.raises(ValueError, match="gradient"):
        tsk.sinkhorn_knopp(scores, 2, 0.1, r, c)
    with torch.no_grad():
        tsk.sinkhorn_knopp(scores, 2, 0.1, r, c)
    tsk.sinkhorn_knopp(scores.detach(), 2, 0.1, r, c)


def test_baggan_iteration_kernels_match_plain_ops(cuda, tmp_path):
    """One iteration with R1 and PPL of a 32x32 BagGAN (ADA at p = 0.6)
    with KERNELS and with PLAIN from the same seed: every kernel launched,
    both resample Functions included; equal draws. The learning rate is 0,
    so every step kind sees equal weights (Adam's first step moves each
    weight by about lr * sign(g), which flips with the rounding of a
    gradient near zero) and the two runs differ only in float32 summation
    order: losses within 1e-4 relative, each step kind's gradients within
    1e-3 of its norm."""
    from ganecdotes_torch.gan.train import STEP_KINDS, BagGANHQ
    from ganecdotes_torch.ops.opset import KERNELS

    cfg = SimpleNamespace(
        out_dir=str(tmp_path), checkpoint_dir=str(tmp_path), is_train=True,
        image_size=32, latent_dim=64, num_channels=3, batch_size=4,
        gan_mode="wgangp", use_ppl=True, r1_lambda=10, ppl_lambda=2,
        path_batch_shrink=2, ppl_decay=0.01, d_reg_every=16, g_reg_every=4,
        mixing_prob=0.9, chl_multiplier=1, res2chlmap={4: 64, 8: 64, 16: 32, 32: 32},
        g_reg_ratio=4 / 5, d_reg_ratio=16 / 17, augment=True, augment_p=0,
        ada_target=0.6, ada_length=500000, lr=0.0, beta1=0.0,
        generator_params=dict(mlp_layers=2), losses_to_print=["g_gan", "d", "g_ppl"])
    real = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    runs = []
    for ops in (KERNELS, PLAIN):
        _build.reset_launches()
        gan = BagGANHQ(cfg, seed=2, device=cuda, ops=ops)
        gan.ada_state["p"].fill_(0.6)
        gan.keep_first_grads = True
        gan.set_input(real, iter_no=0)
        gan.optimize_parameters()
        torch.cuda.synchronize()
        runs.append((gan, dict(_build.LAUNCHES)))
    (kern, launches), (plain, plain_launches) = runs
    assert all(v > 0 for k, v in launches.items() if k != "sinkhorn_knopp"), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    for a, b in zip(kern.draws.g_aug, plain.draws.g_aug):
        assert torch.equal(a, b)
    for name in ("d", "d_r1", "g_gan", "g_ppl"):
        a, b = float(getattr(kern, "loss_" + name)), float(getattr(plain, "loss_" + name))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (name, a, b)
    for kind in STEP_KINDS:
        diff = sum(float((u - v).square().sum())
                   for u, v in zip(kern.first_grads[kind], plain.first_grads[kind]))
        norm = sum(float(v.square().sum()) for v in plain.first_grads[kind])
        assert diff <= (1e-3) ** 2 * norm, (kind, (diff / norm) ** 0.5)
