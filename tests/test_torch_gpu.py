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
the two-pass one (tests/test_selfsup.py:191-195).
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
                                   (3, 5, 7, 36, 20), (1, 9, 3, 4, 132)])
@pytest.mark.parametrize("noise_b", ["one", "batch"])
def test_styled_convs_match_plain(cuda, shape, noise_b):
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
    (130, 7, 2, 0.5)])
def test_sinkhorn_matches_plain(cuda, b, k, niters, eps):
    """Small, ragged (B and K no multiple of any tile; K % 4 != 0 takes the
    scalar loads), niters = 0, and K below one warp's width."""
    g = torch.Generator().manual_seed(b + k)
    scores = torch.randn(b, k, generator=g).to(cuda)
    r = torch.rand(k, generator=g) + 0.1
    c = torch.rand(b, generator=g) + 0.1
    r, c = (r / r.sum()).to(cuda), (c / c.sum()).to(cuda)
    before = _build.LAUNCHES["sinkhorn_knopp"]
    q = tsk.sinkhorn_knopp(scores, niters, eps, r, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sinkhorn_knopp"] == before + 1
    torch.testing.assert_close(q, tsk.sinkhorn_knopp_ref(scores, niters, eps, r, c),
                               atol=1e-4, rtol=0)
    # deterministic: no atomics
    torch.testing.assert_close(tsk.sinkhorn_knopp(scores, niters, eps, r, c), q,
                               atol=0, rtol=0)


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
    assert all(v > 0 for v in launches.values()), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    np.testing.assert_allclose(kern.loss_history, plain.loss_history, rtol=1e-4)
    for a, b in zip(tree_leaves(kern.ssl_params), tree_leaves(plain.ssl_params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
