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

from ganecdotes_torch.gan import ada
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


def _path_shapes(b, up):
    """The float32 StyledConv shapes of ffhq256's and pidray256's generators
    (widths 512 at 4^2 to 128 at 256^2) at batch b."""
    from ganecdotes_torch.models.stylegan2.generator import channel_map

    ch = channel_map()
    res = [2 ** k for k in range(2, 9)]
    if up:
        return [(b, r // 2, r // 2, ch[r // 2], ch[r]) for r in res[1:]]
    return [(b, r, r, ch[r], ch[r]) for r in res]


@pytest.mark.parametrize("b", [32, 20, 10])
@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
def test_tf32_styled_convs_match_plain_at_the_path_shapes(cuda, b, up):
    """Every float32 StyledConv layer of the ffhq256 request of 32 (noise
    broadcast) and of pidray256's G at B = 20 and PPL's B = 10 (one noise
    map per sample), on the 3xTF32 GEMMs: the tap splits 9, 3 and 1 among
    them (``tf32_plan``), each within CONV_TOL of the plain version."""
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    fn, ref = getattr(tmc, name), getattr(tmc, name + "_ref")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = set()
    for shape in _path_shapes(b, up):
        before = dict(tmc.VARIANT_LAUNCHES)
        a = _styled_inputs(*shape, 1 if b == 32 else b, up, cuda, seed=shape[1])
        torch.testing.assert_close(fn(*a), ref(*a), **CONV_TOL)
        assert tmc.VARIANT_LAUNCHES[(name, "tf32x3")] == before[(name, "tf32x3")] + 1
        splits.add(tmc.tf32_plan(*shape, up, sms).nsplit)
        del a
    assert splits == ({1} if up else {9, 1} if b == 32 else {9, 3, 1})


@pytest.mark.parametrize("shape", [(8, 8, 8, 512, 512), (20, 8, 8, 512, 512),
                                   (2, 32, 32, 256, 128), (4, 72, 72, 32, 68)])
@pytest.mark.parametrize("up", [False, True])
def test_tf32_styled_convs_repeat_bit_for_bit(cuda, shape, up):
    """Two launches of the float32 StyledConvs on the same input give the
    same bits: no atomics; the non-up taps split 9 ways (8x8 at B = 8), 3
    (at B = 20) or not at all, the splits summed in order."""
    args = _styled_inputs(*shape, shape[0], up, cuda, seed=3)
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    before = dict(tmc.VARIANT_LAUNCHES)
    assert torch.equal(fn(*args), fn(*args))
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    assert tmc.VARIANT_LAUNCHES[(name, "tf32x3")] == before[(name, "tf32x3")] + 2


@pytest.mark.parametrize("shape", [(8, 256, 256, 16, 16), (1, 256, 256, 16, 16),
                                   (8, 128, 128, 32, 32), (1, 128, 128, 32, 32)])
@pytest.mark.parametrize("noise_b", ["one", "batch"])
def test_styled_convs_match_plain_at_the_lean_map(cuda, shape, noise_b):
    """The BagGAN generator's lean width map (16 channels at 256^2, 32 at
    128^2): the narrowest layers any path gives the kernels (the narrow
    variant at these widths). The non-up conv at (B, r, r, C, C), the up
    conv from the level below, (B, r/2, r/2, 2C) to C channels, as the
    pidray generator runs them; B = 1 (the one-shot synthesis) and 8 (a
    request), the noise broadcast or per sample."""
    B, H, W, Ci, Co = shape
    nb = 1 if noise_b == "one" else B
    before = dict(_build.LAUNCHES)
    a = _styled_inputs(B, H, W, Ci, Co, nb, False, cuda)
    torch.testing.assert_close(tmc.styled_conv3x3(*a),
                               tmc.styled_conv3x3_ref(*a), **CONV_TOL)
    a = _styled_inputs(B, H // 2, W // 2, 2 * Ci, Co, nb, True, cuda)
    out = tmc.styled_up_conv3x3(*a)
    torch.testing.assert_close(out, tmc.styled_up_conv3x3_ref(*a), **CONV_TOL)
    torch.testing.assert_close(out, tmc.styled_up_conv3x3_xla(*a), **CONV_TOL)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["styled_conv3x3"] == before["styled_conv3x3"] + 1
    assert _build.LAUNCHES["styled_up_conv3x3"] == before["styled_up_conv3x3"] + 1


def test_loaded_reference_checkpoint_is_bit_equal_on_the_card(cuda, tmp_path):
    """A rosinality {'g_ema': sd} .pt (seeded numpy, noise strengths set)
    loads to a generator whose image and features on the card, through the
    kernels, equal those of the generator converted from the same state
    dict in memory, bit for bit."""
    from torch_reference_files import N_MLP, STYLE_DIM, rosinality_g_ema

    from ganecdotes_torch.models.stylegan2.convert import (
        convert_torch_generator_state,
        load_torch_checkpoint,
    )
    from ganecdotes_torch.models.stylegan2.generator import generator_forward

    sd = {k: torch.from_numpy(v) for k, v in rosinality_g_ema(64, seed=5).items()}
    path = str(tmp_path / "g.pt")
    torch.save({"g_ema": sd}, path)
    loaded = load_torch_checkpoint(path, 64, n_mlp=N_MLP).to(cuda)
    source = convert_torch_generator_state(sd, 64, n_mlp=N_MLP).to(cuda)
    w = torch.randn(8, STYLE_DIM, generator=torch.Generator().manual_seed(6)).to(cuda)
    mean = torch.randn(1, STYLE_DIM,
                       generator=torch.Generator().manual_seed(7)).to(cuda)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        img_a, feats_a = generator_forward(loaded, [w], input_is_latent=True,
                                           truncation=0.7, truncation_latent=mean)
        img_b, feats_b = generator_forward(source, [w], input_is_latent=True,
                                           truncation=0.7, truncation_latent=mean)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["styled_conv3x3"] > before["styled_conv3x3"]
    assert torch.equal(img_a, img_b)
    assert all(torch.equal(a, b) for a, b in zip(feats_a, feats_b))


@pytest.mark.parametrize("kw", [dict(up=2, pad=(2, 1)), dict(pad=(1, 1)),
                                dict(pad=(-1, 2, 0, 1)), dict(up=2, pad=(1, -1)),
                                dict(up=(2, 1), pad=(2, 1, 0, 0))])
def test_upfirdn2d_matches_plain(cuda, kw):
    x = torch.randn(2, 9, 11, 5, generator=torch.Generator().manual_seed(0)).to(cuda)
    k = tup.make_kernel((1, 3, 3, 1), gain=4.0)
    torch.testing.assert_close(tup.upfirdn2d(x, k, **kw),
                               tup.upfirdn2d_ref(x, k, **kw), atol=ATOL, rtol=0)


SYM6 = np.asarray(ada.SYM6, np.float32)  # ADA's 12 wavelet taps
FIR_AXES = {"1": (1, 1), "up2": (2, 1), "down2": (1, 2)}


def _fir_kernel(name):
    """A rank-1 2-D kernel: the 4-tap blur (gain 4), SYM6 x its reverse, or
    the blur's taps down and SYM6's across."""
    if name == "blur":
        return tup.make_kernel((1, 3, 3, 1), gain=4.0)
    if name == "sym6":
        return np.outer(SYM6, SYM6[::-1])
    return np.outer(np.float32([1, 3, 3, 1]) / 8, SYM6)


@pytest.mark.parametrize("ax", FIR_AXES)
@pytest.mark.parametrize("ay", FIR_AXES)
@pytest.mark.parametrize("taps", ["blur", "sym6"])
def test_upfirdn2d_every_case_matches_plain(cuda, ax, ay, taps):
    """Every (up, down) pair the kernel is instantiated for, per axis, at
    C = 3 and 5 (a channel a thread, the (column, channel) row flattened)
    and C = 128 (four channels a thread, 32-channel slices), 4 and 12 taps,
    ragged sizes and a crop: one launch a call, within 1e-5 of the largest
    plain output (sums of at most 144 float32 products, in another order)."""
    (ux, dx), (uy, dy) = FIR_AXES[ax], FIR_AXES[ay]
    k = _fir_kernel(taps)
    n = k.shape[0]
    g = torch.Generator().manual_seed(n + 3 * ux + 5 * dy)
    for c in (3, 5, 128):
        for hw, pad in (((13, 21), (n // 2, n // 2 - 1, 1, 2)),
                        ((37, 70), (n // 2, -1, -2, n // 2))):
            x = torch.randn(2, *hw, c, generator=g).to(cuda)
            kw = dict(up=(ux, uy), down=(dx, dy), pad=pad)
            before = _build.LAUNCHES["upfirdn2d"]
            got = tup.upfirdn2d(x, k, **kw)
            want = tup.upfirdn2d_ref(x, k, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["upfirdn2d"] == before + 1
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=ATOL * max(1.0, want.abs().max().item()))


# the bias gradient against the plain sum: chip_smoke.py's kernel gate
KERNEL_TOL = 1e-4  # max |kernel - plain| <= KERNEL_TOL * max(1, max |plain|)


@pytest.mark.parametrize("shape", [(8, 512), (3, 7, 6), (5, 3), (37, 1),
                                   (9, 3), (2, 5, 4), (20, 16, 16, 512),
                                   (3, 1040), (0, 8)])
def test_fused_leaky_relu_matches_plain(cuda, shape):
    """The forward with and without a bias, and the backward kernel at C =
    1, 3, 4, 6, 512 and 1040 (two block columns) and on an empty tensor:
    forward and dx equal their plain versions bit for bit (the same rounded
    steps), db within KERNEL_TOL of the plain sum (another order) and equal
    over two launches (no atomics); one count per launch."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g).to(cuda)
    b = torch.randn(shape[-1], generator=g).to(cuda)
    for bias in (b, None):
        before = dict(_build.LAUNCHES)
        y = tfa.fused_leaky_relu(x, bias)
        want = tfa.fused_leaky_relu_ref(x, bias)
        torch.testing.assert_close(y, want, atol=ATOL, rtol=0)
        assert torch.equal(y, want)
        gy = torch.randn(*shape, generator=g).to(cuda)
        dx, db = tfa.fused_leaky_relu_bwd(gy, y, with_db=bias is not None)
        want_dx, want_db = tfa.fused_leaky_relu_bwd_ref(gy, y, with_db=bias is not None)
        torch.cuda.synchronize()
        launched = 0 if x.numel() == 0 else 1
        assert _build.LAUNCHES["fused_leaky_relu"] == before["fused_leaky_relu"] + launched
        assert (_build.LAUNCHES["fused_leaky_relu_bwd"]
                == before["fused_leaky_relu_bwd"] + launched)
        assert torch.equal(dx, want_dx)
        if bias is None:
            assert db is None and want_db is None
            continue
        torch.testing.assert_close(db, want_db, rtol=0,
                                   atol=KERNEL_TOL * max(1.0, want_db.abs().max().item()))
        assert torch.equal(tfa.fused_leaky_relu_bwd(gy, y)[1], db)
        # the Function's backward runs the same kernel
        xr, br = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        gx, gb = torch.autograd.grad(tfa.fused_leaky_relu(xr, br), (xr, br), gy)
        assert torch.equal(gx, dx) and torch.equal(gb, db)


# B = 1 (the one-shot synthesis), 8 (a request), 20 (the training CLI's
# G step and D step synthesis)
LEAN_NARROW = [(b, r, r, c, c) for b in (1, 8, 20)
               for r, c in ((64, 64), (128, 32), (256, 16))]
LEAN_NARROW_UP = [(b, r // 2, r // 2, 2 * c, c) for b in (1, 8, 20)
                  for r, c in ((64, 64), (128, 32), (256, 16))]


@pytest.mark.parametrize("up,shape", [(False, s) for s in LEAN_NARROW]
                         + [(True, s) for s in LEAN_NARROW_UP])
@pytest.mark.parametrize("noise_b", ["one", "batch"])
def test_lean_rows_run_their_variant_and_repeat(cuda, up, shape, noise_b):
    """Every lean-map row of kernels 3 and 4 with Cout <= 64 (B = 1, 8 and
    20, the noise broadcast and per sample): the wrapper launches the variant
    ``variant`` names for the shape, once, within the tolerance of the
    plain version, and two launches agree bit for bit."""
    B, H, W, Ci, Co = shape
    nb = 1 if noise_b == "one" else B
    a = _styled_inputs(B, H, W, Ci, Co, nb, up, cuda, seed=5)
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    fn, ref = getattr(tmc, name), getattr(tmc, name + "_ref")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = tmc.variant(Co, up, B * H * W, sms)
    before = dict(tmc.VARIANT_LAUNCHES)
    out = fn(*a)
    torch.cuda.synchronize()
    ran = [k for k, n in tmc.VARIANT_LAUNCHES.items() if n != before[k]]
    assert ran == [(name, want)], ran
    torch.testing.assert_close(out, ref(*a), **CONV_TOL)
    assert torch.equal(fn(*a), out)


@pytest.mark.parametrize("cout", [16, 32, 64])
@pytest.mark.parametrize("up", [False, True], ids=["conv", "up_conv"])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 8])
def test_narrow_kernel_at_every_split_matches_plain(cuda, cout, up, nsplit):
    """The narrow kernel with its channel chunks whole and split 2, 3 and
    8 ways (a cluster of as many blocks), on ragged shapes: H and W not
    multiples of the tile, Cin not a multiple of the 16-channel chunk (36:
    3 chunks, the last mostly zero; 8 splits at 120 channels), per-sample
    noise; against the plain version (for the up body the composed
    sub-pixel form, as the kernel computes) and, for the up body,
    conv_transpose + blur; two launches bit for bit."""
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    taps = tmc._blur_taps(name, (1, 3, 3, 1))
    cin = 120 if nsplit > 3 else 36
    for B, H, W in ((3, 13, 37), (1, 6, 70)):
        a = _styled_inputs(B, H, W, cin, cout, B, up, cuda, seed=nsplit)
        out = tmc._narrow_forward(name, *a, up=up, taps=taps, nsplit=nsplit)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, getattr(tmc, name + "_ref")(*a), **CONV_TOL)
        if up:
            torch.testing.assert_close(out, tmc.styled_up_conv3x3_xla(*a), **CONV_TOL)
        assert torch.equal(tmc._narrow_forward(name, *a, up=up, taps=taps, nsplit=nsplit),
                           out)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        tfa.fused_leaky_relu(x.double())
    with pytest.raises(ValueError):
        tfa.fused_leaky_relu(x.transpose(1, 2))
    with pytest.raises(ValueError):  # 17 taps on an axis
        tup.upfirdn2d(x, np.ones((1, 17), np.float32), pad=(8, 8, 0, 0))
    with pytest.raises(ValueError):  # not separable
        tup.upfirdn2d(x, np.eye(3, dtype=np.float32), pad=(1, 1))
    with pytest.raises(TypeError):
        tup.upfirdn2d(x, torch.ones(4, 4, device=cuda))
    k = tup.make_kernel((1, 3, 3, 1))
    with pytest.raises(ValueError):
        tup.upfirdn2d(x, k, up=3, pad=(2, 1))
    with pytest.raises(ValueError):
        tup.upfirdn2d(x, k, down=3, pad=(1, 1))
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


def test_folded_server_matches_unfused_server(cuda):
    """The folded request against the unfused one on the card: the image
    bit-equal, logits within 1e-4 * max(1, max |unfused|), labels on 99.9%
    of the pixels, sample 0's embedding within the logits' gate
    (chip_smoke.py's phase 4 gates)."""
    from ganecdotes_torch.pipeline.serving import OneShotServer

    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=256,
                         gen_args=dict(size=64, style_dim=512, n_mlp=8),
                         classes=["c%d" % i for i in range(8)])
    for size, hlen in (("XXS", 1300), ("S", 3000)):
        sc = SimpleNamespace(
            hfc_prep_args=dict(swav_args=dict(hlen=hlen, nclasses=16,
                                              nprototypes=32, projn_nw="linear",
                                              hf_interp="nearest")),
            seg_args=dict(size=size, in_ch=16))
        server = OneShotServer(mc, sc, device=cuda, seed=3)
        z = torch.randn(8, 512, generator=torch.Generator().manual_seed(4))
        img, logits, emb0 = server.infer_folded(z)
        u_img, u_logits, u_emb0 = server.infer(z)
        assert torch.equal(img, u_img)
        scale = max(1.0, u_logits.abs().max().item())
        assert (logits - u_logits).abs().max().item() <= 1e-4 * scale
        # z0: sample 0 projected alone against its row of the batch's
        # projection (another GEMM shape), the logits' gate
        assert (emb0 - u_emb0).abs().max().item() <= \
            1e-4 * max(1.0, u_emb0.abs().max().item())
        agree = (logits.argmax(-1) == u_logits.argmax(-1)).float().mean().item()
        assert agree >= 0.999


@pytest.mark.parametrize("projn_nw,interp", [("2-layer", "nearest"),
                                             ("1-layer", "nearest"),
                                             ("2-layer", "bilinear")])
def test_unfolded_request_of_b_equals_b_requests_of_one(cuda, projn_nw, interp):
    """A request of 8 through a non-linear projection (or bilinear
    features), which serves unfused with each image's own BatchNorm
    statistics, against each image's features projected alone on the card:
    logits within 1e-4 * max(1, max |logits|), labels equal (the synthesis
    is the request's in both: it is not batch-invariant to the last bit)."""
    from ganecdotes_torch.pipeline.serving import OneShotServer
    from ganecdotes_torch.selfsup.heads import one_shot_segmentor_apply

    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=256,
                         gen_args=dict(size=64, style_dim=512, n_mlp=8),
                         classes=["c%d" % i for i in range(8)])
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(hlen=1300, nclasses=16, nprototypes=32,
                                          projn_nw=projn_nw, hf_interp=interp)),
        seg_args=dict(size="XXS", in_ch=16))
    server = OneShotServer(mc, sc, device=cuda, seed=5)
    assert not server.foldable
    z = torch.randn(8, 512, generator=torch.Generator().manual_seed(6))
    _, labels, z0 = server.serve(z)
    with torch.inference_mode():
        _, feats = server._synthesize(z, False)
        emb = server._project(feats)
        logits = one_shot_segmentor_apply(server.seg_params, emb, server.seg_size)
        assert torch.equal(labels, logits.argmax(-1))
        assert torch.equal(z0, emb[:1].argmax(-1))
        scale = max(1.0, logits.abs().max().item())
        for i in range(8):
            logits_i = one_shot_segmentor_apply(
                server.seg_params, server._project([f[i : i + 1] for f in feats]),
                server.seg_size)
            assert (logits[i : i + 1] - logits_i).abs().max().item() <= 1e-4 * scale
            assert torch.equal(labels[i : i + 1], logits_i.argmax(-1))


def test_session_grid_is_the_servers_request(cuda, tmp_path):
    """The GUI session's grid refresh after Update/Train on the card: one
    request through the pipeline's server, assembled on the card, equals
    the server's ``serve`` of the same latents assembled as the JAX GUI
    assembles it (numpy, tile by tile), bit for bit."""
    import os
    import textwrap

    from test_pipeline import TINY_MODEL, TINY_SWAV, TINY_TRAINER

    from ganecdotes_torch.gui.interactive_labeller import InteractiveSession
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
    from ganecdotes_torch.selfsup.swav import init_swav_params
    from ganecdotes_torch.utils.serialization import save_pytree
    from ganecdotes_torch.utils.visualization import visualize_label_mask

    cfg = {}
    for name, body in [("model", TINY_MODEL), ("trainer", TINY_TRAINER),
                       ("seg", TINY_SWAV)]:
        cfg[name] = str(tmp_path / f"{name}_config.py")
        with open(cfg[name], "w") as f:
            f.write(textwrap.dedent(body))
    out = str(tmp_path / "gui")
    os.makedirs(out)
    save_pytree(os.path.join(out, "swav_params.npz"), init_swav_params(
        3584, 16, 32, generator=torch.Generator().manual_seed(1)))
    pipe = OneShotPipeline(out, segmentor="hfc_with_swav", num_test_samples=8,
                           custom=cfg, device=cuda)
    pipe.seg_config.train_hfc = False
    pipe.seg_config.hfc_prep_args["train"] = False
    pipe.setup()
    session = InteractiveSession(pipe)
    assert session.num_outs == 8
    session.labels[0] = pipe.one_shot_label[0].cpu().numpy().astype(np.uint8)
    _build.reset_launches()
    grid = session.update_or_train()
    assert all(_build.LAUNCHES[k] > 0 for k in ("styled_conv3x3",
                                                 "styled_up_conv3x3"))
    img, pred, _ = pipe.server.serve(torch.as_tensor(session.out_latents),
                                     input_is_latent=True)
    img, pred = img.cpu().numpy(), pred.cpu().numpy()
    tiles = []
    for i in range(8):
        tiles += [np.clip(img[i], -1, 1) * 0.5 + 0.5,
                  visualize_label_mask(pred[i], pipe.color_map)]
    h, w, _ = tiles[0].shape
    want = np.zeros((4 * h, 4 * w, 3), np.float32)
    for k, t in enumerate(tiles):
        want[k // 4 * h : (k // 4 + 1) * h, k % 4 * w : (k % 4 + 1) * w] = t
    np.testing.assert_array_equal(grid, want)


def test_pipeline_kernels_match_plain_ops(cuda, tmp_path):
    """The tiny one-shot pipeline (tests/test_pipeline.py's configs, 3 test
    samples, train_hfc False with one swav_params.npz) with KERNELS and with
    PLAIN from the same seed, at chip_smoke.py's phase 8 gates: one-shot
    features within 1e-3 * max(1, max |plain|), the fine-tune loss after its
    first chunk within 1e-3 and after the last 2e-2 relative, the test labels
    on 99.9% of the pixels, the mean mask IoU within 1e-2."""
    import os
    import shutil
    import textwrap

    from test_pipeline import TINY_MODEL, TINY_SWAV, TINY_TRAINER

    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
    from ganecdotes_torch.selfsup.swav import init_swav_params
    from ganecdotes_torch.utils.serialization import save_pytree

    cfg = {}
    for name, body in [("model", TINY_MODEL), ("trainer", TINY_TRAINER),
                       ("seg", TINY_SWAV)]:
        cfg[name] = str(tmp_path / f"{name}_config.py")
        with open(cfg[name], "w") as f:
            f.write(textwrap.dedent(body))
    params = str(tmp_path / "swav_params.npz")
    save_pytree(params, init_swav_params(
        3584, 16, 32, generator=torch.Generator().manual_seed(1)))
    runs = []
    for name, ops in (("kernels", KERNELS), ("plain", PLAIN)):
        out = str(tmp_path / name)
        os.makedirs(out)
        shutil.copy(params, out)
        _build.reset_launches()
        pipe = OneShotPipeline(out, segmentor="hfc_with_swav", custom=cfg,
                               num_test_samples=3, device=cuda, ops=ops, seed=2)
        pipe.seg_config.train_hfc = False
        pipe.seg_config.hfc_prep_args["train"] = False
        pipe.run_pipeline()
        torch.cuda.synchronize()
        runs.append((pipe, dict(_build.LAUNCHES)))
    (kern, launches), (plain, plain_launches) = runs
    serving = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
               "styled_up_conv3x3")
    assert all(launches[k] > 0 for k in serving), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    assert kern.preprocessor.pretrain_count == plain.preprocessor.pretrain_count == 0
    f, p = kern.one_shot_train_features, plain.one_shot_train_features
    assert (f - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())
    (_, k1, _), (_, p1, _) = kern.finetune_log[0], plain.finetune_log[0]
    (_, kl, _), (_, pl, _) = kern.finetune_log[-1], plain.finetune_log[-1]
    assert abs(k1 - p1) <= 1e-3 * abs(p1) and abs(kl - pl) <= 2e-2 * abs(pl)
    assert (kern.pred_labels == plain.pred_labels).mean() >= 0.999
    assert abs(kern.mean_mask_iou - plain.mean_mask_iou) <= 1e-2


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


@pytest.mark.parametrize("size,in_ch", [("S", 124), ("XS", 512)])
def test_finetune_repeats_bit_for_bit(cuda, size, in_ch):
    """Two fine-tunes of a head from one init on the same features end with
    equal params (cuDNN's deterministic algorithms: the default ones for
    the heads' convs sum in a run-dependent order)."""
    from ganecdotes_torch.pipeline import losses
    from ganecdotes_torch.pipeline.trainer import make_supervised_finetune
    from ganecdotes_torch.selfsup.heads import (
        init_one_shot_segmentor,
        one_shot_segmentor_apply,
    )

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 64, in_ch, generator=g).to(cuda)
    label = torch.randint(0, 4, (1, 64, 64), generator=g).to(cuda)
    init = init_one_shot_segmentor(in_ch, 4, size, generator=g)
    ends, before = [], torch.backends.cudnn.deterministic
    for _ in range(2):
        optimizer, run_chunk = make_supervised_finetune(
            lambda p, st, f: (one_shot_segmentor_apply(p, f, size), st),
            [(1.0, losses.cross_entropy)], 64, 1e-3)
        params = [{k: v.clone().to(cuda) for k, v in layer.items()}
                  for layer in init]
        opt = optimizer.init(params)
        run_chunk(params, opt, (), x, label, 0, 30)
        ends.append([t.detach().clone() for layer in params for t in layer.values()])
    assert torch.backends.cudnn.deterministic == before  # restored after
    assert all(torch.equal(a, b) for a, b in zip(*ends))


@pytest.mark.parametrize("method", ["repurposegan", "datasetgan",
                                    "hfc_with_simclr", "hfc_kmeans"])
def test_method_pipeline_kernels_match_plain_ops(cuda, tmp_path, method):
    """The tiny pipeline of each other method (tests/test_pipeline.py's
    configs; SimCLR and k-means fitted first, k-means cut to n_init 2 and
    max_iter 10) with KERNELS and with PLAIN from the same seed, at
    chip_smoke.py's phase 9 gates: kernels 1-4 launched on the kernels run
    only; each run's one-shot features within 1e-3 * max(1, max |plain|)
    (k-means' one-hot ones equal on 99.9%), as are the k-means fit's block
    features; the plain run then fits on the kernels run's block features
    with its k-means++ picks (centers within 1e-3 * max(1, max |plain|))
    and fine-tunes on the kernels run's one-shot features (one rounding
    step of them moves the fine-tune past the gates: method_rounding.py),
    so the loss after the first chunk is within 1e-3 and after the last
    2e-2 relative, and the test labels agree on 99.9% of the pixels; then
    the kernels run's folded request against its unfused oracle on the
    card: the image equal, logits within 1e-4 * max(1, max |unfused|),
    labels on 99.9%."""
    import textwrap

    from test_pipeline import (
        TINY_DG,
        TINY_KMEANS,
        TINY_MODEL,
        TINY_RP,
        TINY_SIMCLR,
        TINY_TRAINER,
    )

    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

    seg = {"repurposegan": TINY_RP, "datasetgan": TINY_DG,
           "hfc_with_simclr": TINY_SIMCLR,
           "hfc_kmeans": TINY_KMEANS.replace(
               "kmeans_args=dict(verbose=0)",
               "kmeans_args=dict(verbose=0, n_init=2, max_iter=10)")}[method]
    cfg = {}
    for name, body in [("model", TINY_MODEL), ("trainer", TINY_TRAINER),
                       ("seg", seg)]:
        cfg[name] = str(tmp_path / f"{name}_config.py")
        with open(cfg[name], "w") as f:
            f.write(textwrap.dedent(body))

    def close(a, b):
        return (a - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item())

    runs, own = [], []
    for name, ops in (("kernels", KERNELS), ("plain", PLAIN)):
        _build.reset_launches()
        pipe = OneShotPipeline(str(tmp_path / name), segmentor=method,
                               custom=cfg, num_test_samples=3, device=cuda,
                               ops=ops, seed=2)
        pipe.run_pipeline(blocks_to_run=("setup",))
        pre = pipe.preprocessor
        if method == "hfc_kmeans":
            hidden = pre.block_features(pipe.one_shot_latent)
            if runs:
                kern_pre, kern_hidden = runs[0][0].preprocessor, runs[0][2]
                assert all(close(a, b) for a, b in zip(kern_hidden, hidden))
                pre.hfc_model.replay_seeds = kern_pre.hfc_model.seed_indices
                hidden = kern_hidden
            pre.block_features = lambda latent, z_rands=None, h=hidden: h
        own.append(pipe._extract_one_shot_features().detach())
        # both runs fine-tune on the kernels run's features (and fit and
        # pretrain once: the train block would extract them again)
        pipe._extract_one_shot_features = lambda f=own[0]: f
        pipe.run_pipeline(blocks_to_run=("train", "test"))
        torch.cuda.synchronize()
        runs.append((pipe, dict(_build.LAUNCHES),
                     hidden if method == "hfc_kmeans" else None))
    (kern, launches, _), (plain, plain_launches, _) = runs
    serving = ("fused_leaky_relu", "upfirdn2d", "styled_conv3x3",
               "styled_up_conv3x3")
    assert all(launches[k] > 0 for k in serving), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    if method == "hfc_kmeans":
        assert (own[0] == own[1]).float().mean().item() >= 0.999
        for a, b in zip(kern.preprocessor.hfc_model.centers,
                        plain.preprocessor.hfc_model.centers):
            assert close(a, b)
    else:
        assert close(own[0], own[1])
    (_, k1, _), (_, p1, _) = kern.finetune_log[0], plain.finetune_log[0]
    (_, kl, _), (_, pl, _) = kern.finetune_log[-1], plain.finetune_log[-1]
    assert abs(k1 - p1) <= 1e-3 * abs(p1) and abs(kl - pl) <= 2e-2 * abs(pl)
    assert (kern.pred_labels == plain.pred_labels).mean() >= 0.999
    w = torch.as_tensor(kern.test_latents[:3])
    img, logits, _ = kern.server.infer_folded(w, input_is_latent=True)
    u_img, u_logits, _ = kern.server.infer(w, input_is_latent=True)
    assert torch.equal(img, u_img)
    assert (logits - u_logits).abs().max().item() <= \
        1e-4 * max(1.0, u_logits.abs().max().item())
    assert (logits.argmax(-1) == u_logits.argmax(-1)).float().mean().item() >= 0.999


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
                                   (1, 2, 9, 300, 120), (2, 4, 33, 41, 70)])
@pytest.mark.parametrize("negative,alpha", [(False, None), (True, None),
                                            (False, 0.0), (False, 0.05),
                                            (True, 0.05), (True, 1e-40)],
                         ids=["pos", "neg", "zero", "small", "small_neg",
                              "subnormal_neg"])
def test_resample_kernels_match_plain(cuda, shape, negative, alpha):
    """Small, ragged (W and V no multiple of a warp) and flipped (alpha < 0)
    passes at C = 1, 2, 3 and 4, and alpha = 0, |alpha| = 0.05 and a
    subnormal alpha, whose 1/alpha overflows (the adjoint's widest candidate
    windows): the forward kernel equals the plain pass bit for bit (same
    rounded steps), the adjoint agrees to
    1e-5 * max(1, max |plain|) and repeats bit for bit (no atomics). The
    adjoint's scale matters at alpha = 0: every output row folds onto the
    same source rows, so each element sums all V products and reaches tens,
    where two float32 summation orders differ by a few ulps (a 1e-5
    absolute check failed there for some draws of g)."""
    from ganecdotes_torch.ops import resample as trs

    x, alpha, icpt, v = _pass_case(*shape, negative, cuda, alpha=alpha)
    before = dict(_build.LAUNCHES)
    out = trs.resample_rows(x, alpha, icpt, v)
    plain = trs.resample_rows_ref(x, alpha, icpt, v)
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
    assert torch.equal(out, plain)  # the same rounded steps
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
    # the fused act's second derivative in x and in its bias, at C = 1, 3,
    # 4 and 512, with no torch-op backward: both backward passes on the
    # kernels (R1's and WGAN-GP's shape)
    for c in (1, 3, 4, 512):
        xf = torch.randn(6, 5, c, device=cuda)
        wf = torch.randn(6, 5, c, device=cuda)
        for bias in (torch.randn(c, device=cuda), None):
            grads = []
            for fn in (tfa.fused_leaky_relu, tfa.fused_leaky_relu_ref):
                xr = xf.clone().requires_grad_(True)
                ins = (xr,) if bias is None else (xr, bias.clone().requires_grad_(True))
                gs = torch.autograd.grad((wf * fn(*ins) ** 2).sum(), ins, create_graph=True)
                h = gs[0].square().sum() + (gs[1].sin().sum() if len(gs) > 1 else 0)
                before = dict(_build.LAUNCHES)
                grads.append(torch.autograd.grad(h, ins))
                launched = {k: _build.LAUNCHES[k] - before[k]
                            for k in ("fused_leaky_relu", "fused_leaky_relu_bwd")}
                if fn is tfa.fused_leaky_relu:  # the outer pass on both kernels
                    assert launched["fused_leaky_relu"] >= 1
                    assert launched["fused_leaky_relu_bwd"] >= 1
            for u, v in zip(*grads):
                torch.testing.assert_close(u, v, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["down2_sym6", "up2_blur", "up_down_mixed",
                                  "ada_down_x"])
def test_upfirdn2d_double_grad_matches_plain(cuda, case):
    """R1's shape of derivative through the FIR Function at down = 2 and
    with 12 taps: each backward is the kernel again with up and down
    swapped, so all four FIRs in it launch the kernel; within 1e-5 of the
    largest plain element (sums of products of O(1) through four FIRs)."""
    k, up, down, pad = {
        "down2_sym6": (np.outer(SYM6, SYM6), (1, 1), (2, 2), (5, 5, 5, 5)),
        "up2_blur": (tup.make_kernel((1, 3, 3, 1), 4.0), (2, 2), (1, 1), (2, 1, 2, 1)),
        "up_down_mixed": (_fir_kernel("mixed"), (2, 1), (1, 2), (6, 5, 2, 1)),
        "ada_down_x": (SYM6[None, ::-1].copy(), (1, 1), (2, 1), (-1, -1, 0, 0)),
    }[case]
    g = torch.Generator().manual_seed(21)
    x = torch.randn(2, 13, 27, 5, generator=g).to(cuda)
    y = tup.upfirdn2d_ref(x, k, up=up, down=down, pad=pad)
    w = torch.randn(y.shape, generator=g).to(cuda)
    before = _build.LAUNCHES["upfirdn2d"]
    got = _second_order(lambda t: tup.upfirdn2d(t, k, up=up, down=down, pad=pad), x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["upfirdn2d"] == before + 4
    want = _second_order(lambda t: tup.upfirdn2d_ref(t, k, up=up, down=down, pad=pad), x, w)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL * max(1.0, want.abs().max().item()))


def test_augment_kernels_match_plain_ops(cuda):
    """ADA's augment (p = 1 draws: flips, rotations, scales, colour) with
    KERNELS against PLAIN: the four SYM6 wavelet passes launch the FIR
    kernel (4 launches a call), the warp its pass kernel; within 1e-5 of the
    largest plain value (the pass kernel equals its plain version; the
    wavelet passes sum 12 products in another order)."""
    from ganecdotes_torch.gan.ada import augment, sample_transforms
    from ganecdotes_torch.ops.opset import KERNELS

    G, C = sample_transforms(torch.Generator().manual_seed(4), 1.0, 3, 32, 32, cuda)
    img = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(5)).to(cuda) * 2 - 1
    before = dict(_build.LAUNCHES)
    got = augment(img, transform_matrix=(G, C), ops=KERNELS)[0]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["upfirdn2d"] == before["upfirdn2d"] + 4
    assert _build.LAUNCHES["resample_rows"] == before["resample_rows"] + 2
    before = dict(_build.LAUNCHES)
    want = augment(img, transform_matrix=(G, C), ops=PLAIN)[0]
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL * max(1.0, want.abs().max().item()))


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


def _tiny_baggan_config(tmp_path):
    return SimpleNamespace(
        out_dir=str(tmp_path), checkpoint_dir=str(tmp_path), is_train=True,
        image_size=32, latent_dim=64, num_channels=3, batch_size=4,
        gan_mode="wgangp", use_ppl=True, r1_lambda=10, ppl_lambda=2,
        path_batch_shrink=2, ppl_decay=0.01, d_reg_every=16, g_reg_every=4,
        mixing_prob=0.9, chl_multiplier=1, res2chlmap={4: 64, 8: 64, 16: 32, 32: 32},
        g_reg_ratio=4 / 5, d_reg_ratio=16 / 17, augment=True, augment_p=0,
        ada_target=0.6, ada_length=500000, lr=0.0, beta1=0.0,
        generator_params=dict(mlp_layers=2), losses_to_print=["g_gan", "d", "g_ppl"])


def test_baggan_iteration_runs_no_plain_fir_on_the_card(cuda, tmp_path, monkeypatch):
    """One KERNELS iteration of a 32x32 BagGAN with R1 and PPL due runs no
    grouped conv on a CUDA tensor: the plain FIR (``upfirdn2d_ref``, a
    depthwise ``F.conv2d``) runs on none of ADA's four passes, the PPL
    composite's blur, the up StyledConv's backward or the to_rgb
    upsample's backward, and the FIR kernel launches in every step kind."""
    import torch.nn.functional as F

    from ganecdotes_torch.gan.train import STEP_KINDS, STEP_SPANS, BagGANHQ
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.utils import tracing

    conv2d = F.conv2d

    def no_grouped_conv_on_the_card(*args, **kwargs):
        groups = kwargs.get("groups", args[6] if len(args) > 6 else 1)
        assert not (groups > 1 and args[0].is_cuda), "a plain FIR ran on the card"
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", no_grouped_conv_on_the_card)
    real = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    gan = BagGANHQ(_tiny_baggan_config(tmp_path), seed=2, device=cuda, ops=KERNELS)
    gan.ada_state["p"].fill_(0.6)
    gan.set_input(real, iter_no=0)
    tracing.reset()
    tracing.start()
    try:
        gan.optimize_parameters()
    finally:
        tracing.stop()
    launches = {s.name: s.launches for s in tracing.snapshot().spans
                if s.name in STEP_SPANS.values()}
    tracing.reset()
    for kind in STEP_KINDS:
        step = launches[STEP_SPANS[kind]]
        assert step.get("upfirdn2d", 0) > 0, (kind, step)
    with pytest.raises(AssertionError, match="plain FIR"):  # the guard is live
        tup.upfirdn2d_ref(real.to(cuda), tup.make_kernel((1, 3, 3, 1)), pad=(1, 2))


@pytest.mark.parametrize("cudnn_deterministic", [False, True],
                         ids=["default_cudnn", "deterministic_cudnn"])
def test_baggan_iteration_kernels_match_plain_ops(cuda, tmp_path, monkeypatch,
                                                  cudnn_deterministic):
    """One iteration with R1 and PPL of a 32x32 BagGAN (ADA at p = 0.6)
    with PLAIN and with KERNELS from the same seed: every kernel launched,
    both resample Functions included; equal draws. The learning rate is 0,
    so every step kind sees equal weights (Adam's first step moves each
    weight by about lr * sign(g), which flips with the rounding of a
    gradient near zero) and the two runs differ only in float32 summation
    order: losses within 1e-4 relative, each step kind's gradients within
    1e-3 of its norm.

    The PPL loss is a function of gradients through the StyledConv
    composites' leaky ReLUs, whose slope jumps at 0. An input within
    rounding of 0 falls on either side in two runs that sum in other
    orders, and moves the loss by one kink's jump: 1.4e-4 relative for this
    generator on an NVIDIA H100, from one such input, as far as a plain run
    whose FIR outputs move by one rounding step moves it
    (``gan_rounding.py``). So the kernel run's PPL step replays the plain
    run's kink decisions, and each decision it changes must lie within
    1e-5 of the tensor's largest |x| of 0. Both cases run cuDNN's default
    algorithms, as the trainer does, or its deterministic ones."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", cudnn_deterministic)
    from ganecdotes_torch.gan.train import STEP_KINDS, BagGANHQ
    from ganecdotes_torch.ops.opset import KERNELS
    from ganecdotes_torch.utils.kinks import KinkDecisions

    cfg = _tiny_baggan_config(tmp_path)
    real = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    runs, masks = [], None
    for ops in (PLAIN, KERNELS):
        _build.reset_launches()
        gan = BagGANHQ(cfg, seed=2, device=cuda, ops=ops)
        gan.ada_state["p"].fill_(0.6)
        gan.keep_first_grads = True
        kinks = KinkDecisions(masks)

        def ppl_step(draws, step=gan.ppl_step, kinks=kinks):
            with kinks:
                return step(draws)

        gan.ppl_step = ppl_step
        gan.set_input(real, iter_no=0)
        gan.optimize_parameters()
        torch.cuda.synchronize()
        runs.append((gan, dict(_build.LAUNCHES)))
        masks = kinks.masks
    (plain, plain_launches), (kern, launches) = runs
    assert all(v > 0 for k, v in launches.items()
               if k != "sinkhorn_knopp" and not k.endswith("_bf16")), launches
    assert all(v == 0 for v in plain_launches.values()), plain_launches
    assert kinks.calls == len(masks) > 0, (kinks.calls, len(masks))
    assert all(f <= 1e-5 for f in kinks.flips), kinks.flips
    for a, b in zip(kern.draws.g_aug, plain.draws.g_aug):
        assert torch.equal(a, b)
    for name in ("d", "d_r1", "g_gan", "g_ppl"):
        a, b = float(getattr(kern, "loss_" + name)), float(getattr(plain, "loss_" + name))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (name, a, b, kinks.flips)
    for kind in STEP_KINDS:
        diff = sum(float((u - v).square().sum())
                   for u, v in zip(kern.first_grads[kind], plain.first_grads[kind]))
        norm = sum(float(v.square().sum()) for v in plain.first_grads[kind])
        assert diff <= (1e-3) ** 2 * norm, (kind, (diff / norm) ** 0.5)


def test_wgangp_remat_modes_agree(cuda, tmp_path):
    """The D step of a 32x32 BagGAN with the kernels under
    ``wgangp_remat='all'`` (both D forwards and the penalty branch
    recomputed in the backward) and ``'gp'`` (only the penalty branch),
    from the same seed and draws: the same losses within 1e-5 relative and
    D gradients within chip_smoke.py's D-step gate, 2e-3 of the norm (the
    recomputation runs the same kernels; cuDNN's convs may sum in another
    order), and 'all' holds less memory at its peak."""
    from ganecdotes_torch.gan.train import BagGANHQ
    from ganecdotes_torch.ops.opset import KERNELS

    real = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    runs = {}
    for remat in ("all", "gp"):
        cfg = _tiny_baggan_config(tmp_path)
        cfg.wgangp_remat = remat
        gan = BagGANHQ(cfg, seed=2, device=cuda, ops=KERNELS)
        gan.ada_state["p"].fill_(0.6)
        gan.keep_first_grads = True
        gan.set_input(real, iter_no=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = gan.d_step(gan.ref_image, gan.draws)[0]
        torch.cuda.synchronize()
        runs[remat] = (float(loss), gan.first_grads["d"],
                       torch.cuda.max_memory_allocated() - base)
    (la, ga, ma), (lg, gg, mg) = runs["all"], runs["gp"]
    assert abs(la - lg) <= 1e-5 * max(1.0, abs(lg)), (la, lg)
    diff = sum(float((u - v).square().sum()) for u, v in zip(ga, gg))
    norm = sum(float(v.square().sum()) for v in gg)
    assert diff <= (2e-3) ** 2 * norm, (diff / norm) ** 0.5
    assert ma < mg, (ma, mg)


# ---------------------------------------------------------------------------
# the custom ops of the serving export (ops/library.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 4, 4, 512, 512), (8, 32, 32, 512, 256),
                                   (1, 16, 16, 32, 16), (8, 64, 64, 64, 64)])
def test_library_ops_equal_their_wrappers(cuda, shape):
    """Each ``ganecdotes`` custom op launches its wrapper's kernel: the same
    bits, and one launch more on the wrapper's count per call (the narrow
    and the 3xTF32 variants, the up body with both)."""
    from ganecdotes_torch.ops.library import LIBRARY
    from ganecdotes_torch.ops.opset import KERNELS

    B, H, W, Cin, Cout = shape
    for up, name in ((False, "styled_conv3x3"), (True, "styled_up_conv3x3")):
        args = _styled_inputs(B, H, W, Cin, Cout, B, up, cuda)
        want = getattr(KERNELS, name)(*args)
        before = _build.LAUNCHES[name]
        got = getattr(LIBRARY, name)(*args)
        assert _build.LAUNCHES[name] == before + 1
        assert torch.equal(got, want), name
    x = torch.randn(B, H, W, Cin, device=cuda)
    b = torch.randn(Cin, device=cuda)
    assert torch.equal(LIBRARY.fused_leaky_relu(x, b), KERNELS.fused_leaky_relu(x, b))
    k = tup.make_kernel([1, 3, 3, 1], 4)
    for up, down, pad in ((2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (1, 2))):
        before = _build.LAUNCHES["upfirdn2d"]
        got = LIBRARY.upfirdn2d(x, k, up, down, pad)
        assert _build.LAUNCHES["upfirdn2d"] == before + 1
        assert torch.equal(got, KERNELS.upfirdn2d(x, k, up, down, pad))


# ---------------------------------------------------------------------------
# bfloat16: the kernels' bf16 instances
# ---------------------------------------------------------------------------


def _bf16_gate(kern, plain, ref, name):
    """A bf16 kernel (bf16 out) against the fp32 plain version on its own
    bf16 inputs: within the plain bf16 version's error there plus one bf16
    rounding step of the output's scale (chip_smoke.py's phase 16 gate);
    its bf16 instance, and only it, launched."""
    before = dict(_build.LAUNCHES)
    got = kern()
    ran = [k for k, n in _build.LAUNCHES.items() if n != before[k]]
    want, r = plain(), ref()
    got, want, r = [t if isinstance(t, tuple) else (t,) for t in (got, want, r)]
    torch.cuda.synchronize()
    assert ran == [name + "_bf16"], ran
    assert all(g.dtype == torch.bfloat16 for g in got)
    err = max((g.float() - x.float()).abs().max().item() for g, x in zip(got, r))
    plain_err = max((w.float() - x.float()).abs().max().item() for w, x in zip(want, r))
    scale = max(x.abs().max().item() for x in r)
    assert err <= plain_err + 2.0 ** -8 * max(1.0, scale), (name, err, plain_err, scale)


@pytest.mark.parametrize("shape", [(2, 8, 8, 512, 512), (3, 16, 16, 64, 16),
                                   (2, 32, 32, 16, 32), (1, 4, 4, 24, 40),
                                   (3, 5, 7, 72, 24), (20, 4, 4, 512, 512),
                                   (2, 9, 72, 64, 136), (1, 3, 130, 16, 264),
                                   (8, 64, 64, 128, 256)])
@pytest.mark.parametrize("up", [False, True])
def test_bf16_styled_convs_match_plain(cuda, shape, up):
    """Kernels 3 and 4's bf16 bodies at every tile width (Cout 16 to 512,
    ragged 40, 136 and 264) against their plain bf16 versions; Cin of 72
    (a full and a partial 64-channel stage), pixel boxes across images
    (W = 7, W = 4 at B = 20: a partial last box), partial column tiles
    (W = 72, 130) and the up body's (H + 1) x (W + 1) position grids."""
    bf = torch.bfloat16
    args = _styled_inputs(*shape, 1, up, cuda)
    args = [args[0].to(bf), args[1], args[2].to(bf), args[3].to(bf), *args[4:]]
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    ref = tmc.styled_up_conv3x3_ref if up else tmc.styled_conv3x3_ref
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    _bf16_gate(lambda: fn(*args), lambda: ref(*args),
               lambda: ref(*[a.float() for a in args]), name)


@pytest.mark.parametrize("shape", [(8, 8, 8, 512, 512), (2, 32, 32, 256, 128)])
@pytest.mark.parametrize("up", [False, True])
def test_bf16_styled_convs_repeat_bit_for_bit(cuda, shape, up):
    """Two launches on the same input give the same bits: no atomics, the
    tap splits (8x8 at B = 2) summed in order."""
    bf = torch.bfloat16
    args = _styled_inputs(*shape, shape[0], up, cuda, seed=3)
    args = [args[0].to(bf), args[1], args[2].to(bf), args[3].to(bf), *args[4:]]
    fn = tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3
    assert torch.equal(fn(*args), fn(*args))


def test_bf16_memory_bound_kernels_match_plain(cuda):
    """Kernels 1, 1-bwd, 2, 6a and 6b's bf16 instances against their plain
    bf16 versions, C = 3 and C % 4 == 0 alike; the bf16 FIR's tiles at
    ragged shapes (C = 40: a 32- and an 8-channel slice, 16-byte copies;
    ADA's y pass as 4-channel columns; 13 x 37 outputs over 8 x 32 tiles)
    and the bf16 forward pass's (W = 36, 40 and 37: 8-byte, 16-byte and
    2-byte rows, a ragged last run of 8; V = 70: a ragged second tile of
    rows; a steep alpha whose band outgrows the shared buffer) and
    adjoint's (the same widths, S = 70 and 20, steep intercepts, C = 4),
    each launched twice, bit-equal, the adjoint's bits also the float32
    kernel's rounded once."""
    from ganecdotes_torch.ops import resample as trs

    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, 9, 9, 12, generator=g, device=cuda).to(bf)
    b = torch.randn(12, generator=g, device=cuda)
    _bf16_gate(lambda: tfa.fused_leaky_relu(x, b), lambda: tfa.fused_leaky_relu_ref(x, b),
               lambda: tfa.fused_leaky_relu_ref(x.float(), b), "fused_leaky_relu")
    y = tfa.fused_leaky_relu(x, b)
    gy = torch.randn(y.shape, generator=g, device=cuda).to(bf)
    _bf16_gate(lambda: tfa.fused_leaky_relu_bwd(gy, y),
               lambda: tfa.fused_leaky_relu_bwd_ref(gy, y),
               lambda: tfa.fused_leaky_relu_bwd_ref(gy.float(), y.float()),
               "fused_leaky_relu_bwd")
    k = tup.make_kernel((1, 3, 3, 1), gain=4)
    for c in (3, 12):
        xc = torch.randn(2, 8, 8, c, generator=g, device=cuda).to(bf)
        _bf16_gate(lambda: tup.upfirdn2d(xc, k, 2, 1, (2, 1)),
                   lambda: tup.upfirdn2d_ref(xc, k, 2, 1, (2, 1)),
                   lambda: tup.upfirdn2d_ref(xc.float(), k, 2, 1, (2, 1)), "upfirdn2d")
    blur = tup.make_kernel((1, 3, 3, 1))
    sym6 = np.asarray(ada.SYM6, np.float32)[:, None]
    for shape, k2, up, down, pad in (((2, 13, 37, 40), blur, 1, 1, (2, 2)),
                                     ((3, 14, 38, 16), blur, 1, 1, (1, 1)),
                                     ((2, 16, 16, 24), blur, 1, 2, (1, 1)),
                                     ((2, 9, 12, 3), sym6, (1, 2), 1, (0, 0, 6, 5)),
                                     ((2, 18, 12, 3), np.ascontiguousarray(sym6[::-1]), 1,
                                      (1, 2), (0, 0, -1, -1)),
                                     ((2, 9, 10, 3), sym6.T, (2, 1), 1, (6, 5, 0, 0))):
        xc = torch.randn(*shape, generator=g, device=cuda).to(bf)
        run = (lambda xc=xc, k2=k2, up=up, down=down, pad=pad:
               tup.upfirdn2d(xc, k2, up, down, pad))
        _bf16_gate(run, lambda xc=xc, k2=k2, up=up, down=down, pad=pad:
                   tup.upfirdn2d_ref(xc, k2, up, down, pad),
                   lambda xc=xc, k2=k2, up=up, down=down, pad=pad:
                   tup.upfirdn2d_ref(xc.float(), k2, up, down, pad), "upfirdn2d")
        assert torch.equal(run(), run()), shape
    for w, v, a in ((36, 70, 0.9), (40, 70, -1.1), (37, 20, 0.7), (40, 70, 3.0)):
        xr = torch.randn(2, 3, 200, w, generator=g, device=cuda).to(bf)
        al = torch.tensor([a, -a], device=cuda)
        ic = (torch.arange(w, device=cuda) * 0.5 + 40
              + torch.rand(2, w, generator=g, device=cuda))
        run = lambda xr=xr, al=al, ic=ic, v=v: trs.resample_rows(xr, al, ic, v)
        _bf16_gate(run, lambda xr=xr, al=al, ic=ic, v=v: trs.resample_rows_ref(xr, al, ic, v),
                   lambda xr=xr, al=al, ic=ic, v=v: trs.resample_rows_ref(xr.float(), al, ic, v),
                   "resample_rows")
        assert torch.equal(run(), run()), (w, v, a)
    # the bf16 adjoint's tiles: 8-byte, 16-byte and 2-byte rows, S = 70 and
    # 20 (a ragged last tile of 32 source rows, and less than one),
    # intercepts climbing 4 rows a column over V = 300 (bands over the
    # shared buffer: read from the cotangent), and C = 4 (a walk of 3
    # channels, then one); the float32 kernel adds the same terms in the
    # same order, so its sums rounded once are the bf16 kernel's bits
    for c, w, s_len, v, a, slope in ((3, 36, 70, 48, 0.9, 0.5), (3, 40, 70, 48, -1.1, 0.5),
                                     (3, 37, 20, 48, 0.7, 0.5), (3, 40, 70, 300, 1.0, 4.0),
                                     (4, 40, 70, 48, 0.9, 0.5)):
        gr = torch.randn(2, c, v, w, generator=g, device=cuda).to(bf)
        al = torch.tensor([a, -a], device=cuda)
        ic = ((torch.arange(w, device=cuda) - w / 2) * slope
              + torch.rand(2, w, generator=g, device=cuda) * s_len
              + torch.tensor([[-0.5 * a * v], [0.5 * a * v]], device=cuda))
        run = lambda gr=gr, al=al, ic=ic, s=s_len: trs.resample_rows_t(gr, al, ic, s)
        _bf16_gate(run,
                   lambda gr=gr, al=al, ic=ic, s=s_len: trs.resample_rows_t_ref(gr, al, ic, s),
                   lambda gr=gr, al=al, ic=ic, s=s_len: trs.resample_rows_t_ref(
                       gr.float(), al, ic, s), "resample_rows_t")
        assert torch.equal(run(), run()), (c, w, s_len, v, a)
        assert torch.equal(run(), trs.resample_rows_t(gr.float(), al, ic, s_len).to(bf)), \
            (c, w, s_len, v, a)
    xr = torch.randn(2, 3, 24, 16, generator=g, device=cuda).to(bf)
    alpha = torch.tensor([0.9, -1.1], device=cuda)
    icpt = torch.rand(2, 16, generator=g, device=cuda) * 20
    _bf16_gate(lambda: trs.resample_rows(xr, alpha, icpt, 20),
               lambda: trs.resample_rows_ref(xr, alpha, icpt, 20),
               lambda: trs.resample_rows_ref(xr.float(), alpha, icpt, 20), "resample_rows")
    gr = torch.randn(2, 3, 20, 16, generator=g, device=cuda).to(bf)
    _bf16_gate(lambda: trs.resample_rows_t(gr, alpha, icpt, 24),
               lambda: trs.resample_rows_t_ref(gr, alpha, icpt, 24),
               lambda: trs.resample_rows_t_ref(gr.float(), alpha, icpt, 24),
               "resample_rows_t")
    with pytest.raises(TypeError, match="fused_leaky_relu: x is torch.float16"):
        tfa.fused_leaky_relu(x.half(), None)


# ---------------------------------------------------------------------------
# every kernel against memory that nothing wrote
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py as a module: its phase 16 (a) shapes and its
    ``fill_free_memory``."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _randn(shape, g, dev, dtype):
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _act_cases(dtype, dev, g):
    shapes = [(3, 7, 6), (5, 3), (37, 1), (2, 5, 4), (3, 1040), (20, 16, 16, 512)]
    shapes += [shape for kname, _, shape, _, _ in _chip_smoke().gan_d_shapes()
               if kname == "fused_leaky_relu"]
    for shape in shapes:
        x = _randn(shape, g, dev, dtype)
        b = torch.randn(shape[-1], generator=g, device=dev)
        yield f"act {shape}", lambda x, b: tfa.fused_leaky_relu(x, b), (x, b)
        y, gy = tfa.fused_leaky_relu(x, b), _randn(shape, g, dev, dtype)
        yield f"act bwd {shape}", lambda gy, y: tfa.fused_leaky_relu_bwd(gy, y), (gy, y)


def _fir_cases(dtype, dev, g):
    cs = _chip_smoke()
    blur, blur4 = tup.make_kernel((1, 3, 3, 1)), tup.make_kernel((1, 3, 3, 1), gain=4)
    firs = [((2, 9, 11, 5), blur4, 2, 1, (2, 1)), ((2, 9, 11, 5), blur4, (2, 1), 1, (2, 1, 0, 0)),
            ((2, 13, 37, 40), blur, 1, 1, (2, 2)), ((3, 14, 38, 16), blur, 1, 1, (1, 1)),
            ((2, 16, 16, 24), blur, 1, 2, (1, 1)), ((2, 9, 12, 3), SYM6[:, None], (1, 2), 1,
                                                    (0, 0, 6, 5)),
            ((2, 9, 10, 3), SYM6[None], (2, 1), 1, (6, 5, 0, 0))]
    for ax in FIR_AXES:  # every (up, down) pair, ragged, at a thread's 1 and 4 channels
        for ay in FIR_AXES:
            (ux, dx), (uy, dy) = FIR_AXES[ax], FIR_AXES[ay]
            for c in (3, 128):
                firs.append(((2, 37, 70, c), _fir_kernel("sym6"), (ux, uy), (dx, dy),
                             (6, -1, -2, 6)))
    firs += [(sh, blur4, 2, 1, (2, 1)) for sh, _ in cs.path_shapes()["upfirdn2d"]]
    firs += [(shape, blur, 1, 1, tuple(pad)) for kname, _, shape, pad, _ in cs.gan_d_shapes()
             if kname == "upfirdn2d"]
    firs += [(shape, k2, up, down, pad) for _, shape, k2, up, down, pad in cs.gan_fir_shapes()]
    for shape, k2, up, down, pad in firs:
        x = _randn(shape, g, dev, dtype)
        yield (f"fir {shape} up {up} down {down} pad {pad}",
               lambda x, k2=k2, up=up, down=down, pad=pad: tup.upfirdn2d(x, k2, up, down, pad),
               (x,))


# the float32 GEMMs at every tile width (Cout 4 to 136: 32, 64 and 128 wide)
# and tap split (9 at the small grids; 3 at (20, 8, 8); 1 at (4, 72, 72))
STYLED_RAGGED = [(3, 5, 7, 36, 20), (1, 9, 3, 4, 132), (3, 13, 6, 40, 136), (20, 7, 5, 64, 4),
                 (1, 11, 9, 32, 100), (8, 16, 16, 512, 124), (2, 8, 8, 512, 512),
                 (2, 9, 10, 40, 64), (20, 8, 8, 512, 512), (4, 72, 72, 32, 68)]
STYLED_RAGGED_BF16 = [(3, 16, 16, 64, 16), (2, 32, 32, 16, 32), (1, 4, 4, 24, 40),
                      (3, 5, 7, 72, 24), (20, 4, 4, 512, 512), (2, 9, 72, 64, 136),
                      (1, 3, 130, 16, 264)]


def _styled_cases(dtype, dev, g, up):
    """Kernels 3 (up False) and 4 (up True): float32 through both variants
    (the 3xTF32 GEMMs with their weight split, and the narrow kernel at
    every split), bf16 through the wgmma bodies; ragged shapes and phase
    16 (a)'s."""
    name = "styled_up_conv3x3" if up else "styled_conv3x3"
    fn = getattr(tmc, name)
    cs = _chip_smoke()
    phase = [(shape, nb) for n, _, shape, _, nb in cs.bf16_styled_shapes() if n == name]
    taps = tmc._blur_taps(name, (1, 3, 3, 1))
    if dtype is torch.bfloat16:
        for shape, nb in [(s, 1) for s in STYLED_RAGGED_BF16] + phase:
            a = cs.styled_inputs(shape, up, g, dev, nb)
            a = [a[0].to(dtype), a[1], a[2].to(dtype), a[3].to(dtype), *a[4:]]
            yield f"{name} bf16 {shape} nb {nb}", lambda *a: fn(*a), a
        return
    for shape in STYLED_RAGGED:
        a = cs.styled_inputs(shape, up, g, dev, shape[0])
        out = (shape[0], 2 * shape[1], 2 * shape[2], shape[4]) if up else shape[:3] + shape[4:]
        if up:
            body = lambda *a, out=out: tmc._tf32x3_up_conv_forward(*a, taps, out)
        else:
            body = lambda *a, out=out: tmc._tf32x3_conv_forward(*a, out)
        yield f"{name} tf32x3 {shape}", body, a
    for cout in tmc.NARROW_COUTS:
        for nsplit in (1, 2, 3, 8):
            shape = (3, 13, 37, 120 if nsplit > 3 else 36, cout)
            a = cs.styled_inputs(shape, up, g, dev, 3)
            yield (f"{name} narrow {shape} split {nsplit}",
                   lambda *a, n=nsplit: tmc._narrow_forward(name, *a, up=up, taps=taps,
                                                            nsplit=n), a)
    for shape, nb in phase:  # the wrapper's own variant
        a = cs.styled_inputs(shape, up, g, dev, nb)
        yield f"{name} {shape} nb {nb}", lambda *a: fn(*a), a


def _sinkhorn_cases(dtype, dev, g):
    for b, k, niters, eps in ((64, 128, 10, 0.005), (1999, 1237, 3, 0.05), (130, 7, 2, 0.5),
                              (20000, 5000, 10, 0.05), (2003, 5001, 1, 0.05),
                              (257, 8192, 1, 0.05)):
        scores = torch.randn(b, k, generator=g, device=dev)
        r = torch.rand(k, generator=g, device=dev) + 0.1
        c = torch.rand(b, generator=g, device=dev) + 0.1
        yield (f"sinkhorn {(b, k, niters)}",
               lambda s, r, c, n=niters, e=eps: tsk.sinkhorn_knopp(s, n, e, r, c),
               (scores, r / r.sum(), c / c.sum()))


def _resample_cases(dtype, dev, g):
    from ganecdotes_torch.ops import resample as trs

    cases = []
    for shape in ((2, 3, 40, 36, 29), (3, 1, 101, 77, 59), (1, 2, 9, 300, 120),
                  (2, 4, 33, 41, 70)):
        for negative, alpha in ((False, None), (True, None), (False, 0.0), (True, 0.05),
                                (True, 1e-40)):
            x, a, icpt, v = _pass_case(*shape, negative, dev, alpha=alpha)
            cases.append((f"{shape} neg {negative} alpha {alpha}", x, a, icpt, v))
    for w, v, a in ((36, 70, 0.9), (40, 70, -1.1), (37, 20, 0.7), (40, 70, 3.0)):
        ic = (torch.arange(w, device=dev) * 0.5 + 40
              + torch.rand(2, w, generator=g, device=dev))
        cases.append((f"tile W {w} V {v} alpha {a}", torch.randn(2, 3, 200, w, generator=g,
                      device=dev), torch.tensor([a, -a], device=dev), ic, v))
    for case, x, a, icpt, v, _ in _chip_smoke().resample_cases(dev):
        cases.append((case, x, a, icpt, v))
    for case, x, a, icpt, v in cases:
        x = x.to(dtype)
        gout = _randn((x.shape[0], x.shape[1], v, x.shape[3]), g, dev, dtype)
        yield (f"resample {case}",
               lambda x, a, i, v=v: trs.resample_rows(x, a, i, v), (x, a, icpt))
        yield (f"resample_t {case}",
               lambda g, a, i, s=x.shape[2]: trs.resample_rows_t(g, a, i, s), (gout, a, icpt))


UNWRITTEN_GROUPS = {
    "fused_act": _act_cases, "upfirdn2d": _fir_cases,
    "styled_conv3x3": lambda d, dev, g: _styled_cases(d, dev, g, False),
    "styled_up_conv3x3": lambda d, dev, g: _styled_cases(d, dev, g, True),
    "sinkhorn": _sinkhorn_cases, "resample": _resample_cases}
UNWRITTEN_FILL_BYTES = 16 << 30  # far more than any case allocates


@pytest.mark.parametrize("group,dtype", [(k, d) for k in UNWRITTEN_GROUPS
                                         for d in ("float32", "bfloat16")
                                         if (k, d) != ("sinkhorn", "bfloat16")])
def test_kernels_read_only_what_they_write(cuda, group, dtype):
    """Every kernel (its float32 and bf16 instances, both float32 StyledConv
    variants, ragged shapes and phase 16 (a)'s) run once after the caching
    allocator's free memory was filled with 0xFF bytes (NaN in float32 and
    bf16) and once after it was filled with zeros, its inputs copied and
    its outputs and scratch allocated after each fill: the two results
    equal bit for bit, so no kernel reads memory that nothing wrote."""
    g = torch.Generator(device=cuda).manual_seed(17)
    cs = _chip_smoke()
    differ = []
    for label, fn, args in UNWRITTEN_GROUPS[group](getattr(torch, dtype), cuda, g):
        outs = []
        for byte in (cs.POISON, cs.ZERO):
            cs.fill_free_memory(byte, cuda, UNWRITTEN_FILL_BYTES)
            got = fn(*[a.clone() for a in args])
            outs.append(got if isinstance(got, tuple) else (got,))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            differ.append(label)
    assert not differ, differ


def test_checkpoint_of_cuda_tensors_restores_onto_the_card(cuda, tmp_path):
    """``save_pytree_orbax`` of CUDA tensors (float32, bf16, int64; a dict,
    a list, a tuple), restored through ``like`` onto fresh CUDA tensors in
    place, and without ``like`` onto the CPU: bit-equal either way."""
    from ganecdotes_torch.utils.serialization import load_pytree_orbax, save_pytree_orbax

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=g).to(cuda),
            "nested": {"bf16": torch.randn(7, 5, generator=g).to(torch.bfloat16).to(cuda),
                       "idx": torch.randint(-2**40, 2**40, (9,), generator=g).to(cuda)},
            "moments": [torch.randn(3, 3, 8, generator=g).to(cuda) for _ in range(2)],
            "pair": (torch.tensor(3, device=cuda), torch.randn(4, generator=g).to(cuda))}
    save_pytree_orbax(tmp_path / "ckpt", tree)
    like = {"w": torch.zeros(64, 33, device=cuda),
            "nested": {"bf16": torch.zeros(7, 5, dtype=torch.bfloat16, device=cuda),
                       "idx": torch.zeros(9, dtype=torch.int64, device=cuda)},
            "moments": [torch.zeros(3, 3, 8, device=cuda) for _ in range(2)],
            "pair": (torch.tensor(0, device=cuda), torch.zeros(4, device=cuda))}
    ptrs = [t.data_ptr() for t in (like["w"], like["nested"]["bf16"], like["pair"][1])]
    out = load_pytree_orbax(tmp_path / "ckpt", like=like)
    assert out is like and isinstance(out["pair"], tuple)
    assert ptrs == [t.data_ptr() for t in (like["w"], like["nested"]["bf16"], like["pair"][1])]
    cpu = load_pytree_orbax(tmp_path / "ckpt")
    for got, host, want in ((like["w"], cpu["w"], tree["w"]),
                            (like["nested"]["bf16"], cpu["nested"]["bf16"],
                             tree["nested"]["bf16"]),
                            (like["nested"]["idx"], cpu["nested"]["idx"],
                             tree["nested"]["idx"]),
                            (like["pair"][0], cpu["pair"][0], tree["pair"][0]),
                            (like["pair"][1], cpu["pair"][1], tree["pair"][1]),
                            *zip(like["moments"], cpu["moments"], tree["moments"])):
        assert got.device == want.device and host.device.type == "cpu"
        assert got.dtype == host.dtype == want.dtype
        assert torch.equal(got, want) and torch.equal(host, want.cpu())
