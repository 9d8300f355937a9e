"""The index algebra and arithmetic of four CUDA kernels, mirrored in plain
PyTorch on the CPU and held against the JAX package.

The kernels run only on the card (tests/test_torch_gpu.py); these mirrors
compute what they compute, step for step, so that their algebra is checked
here on every run. None of them is on a path of the port.

* csrc/styled_up_conv.cu: the stride-2 transposed conv split into its four
  output phase classes with 4, 2, 2 and 1 taps, then the 4x4 blur (pad 1,
  gain 4, as separable 1-D taps) and the epilogue; held against the JAX
  package's ``styled_up_conv3x3_ref`` (the composed sub-pixel form) and
  ``styled_up_conv3x3_xla`` (conv_transpose + blur) at a ragged shape,
  1e-5 absolute (sums of 4 * Cin = 32 terms of O(0.1)).
* csrc/styled_conv.cu: the 'same' 3x3 conv as a GEMM over 9 taps, tap
  (dy, dx) reading pixel (y + dy - 1, x + dx - 1) with zero fill, in
  32-channel stages each summed from 0 and added to the running sum, then
  the epilogue in the kernel's order; held against the JAX package's
  ``styled_conv3x3_ref`` at a ragged shape, 1e-5 absolute (sums of
  9 * Cin = 360 terms of O(0.1)).
* the 3xTF32 arithmetic both StyledConvs share (csrc/tf32x3.cuh): each fp32 operand split into a TF32
  big part and a TF32 small part (round to nearest, ties away, as
  cvt.rna.tf32.f32: add half of the 13 dropped mantissa bits, then mask
  them), three products summed in fp32.
* csrc/affine_warp.cu's gather adjoint: one output element per thread, a
  candidate window of v from the monotone tap index, membership and
  coefficient from the forward's geometry; held against ``_resample_pass_t``
  and the JAX Pallas ``resample_rows_t`` in interpret mode, 1e-5 absolute
  (sums of a few products of O(1), in another order).
* csrc/sinkhorn.cu's fused schedule: one read of each row per pass, niters
  + 1 passes; a pass's row potentials and its column log-sum-exp come from
  the same read, per-chunk column partials are merged in chunk order, and
  the last pass writes q. Held against the JAX package's fused Pallas
  variant in interpret mode and the port's ``sinkhorn_knopp_ref``, 1e-4
  absolute on codes in [0, 1] (tests/test_torch_sinkhorn.py's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ganecdotes_tpu.ops import affine_warp_pallas as jawp
from ganecdotes_tpu.ops import modulated_conv_pallas as jmc
from ganecdotes_tpu.ops.sinkhorn_pallas import sinkhorn_knopp_pallas
from ganecdotes_torch.ops import affine_warp as taw
from ganecdotes_torch.ops.sinkhorn import sinkhorn_knopp_ref

UP_TOL = dict(atol=1e-5, rtol=0)
CONV3_TOL = dict(atol=1e-5, rtol=0)
SINKHORN_TOL = dict(atol=1e-4, rtol=0)
ADJ_TOL = dict(atol=1e-5, rtol=0)
# the GPU tests' tolerance for the conv kernels against their plain
# versions (tests/test_torch_gpu.py CONV_TOL)
CONV_TOL = dict(atol=1e-4, rtol=1e-5)


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


# ---------------------------------------------------------------------------
# the up StyledConv: 9-tap sub-pixel transposed conv, blur, epilogue
# ---------------------------------------------------------------------------


def _subpixel_up_conv(x, w, s, demod, noise, noise_weight, bias,
                      blur_kernel=(1, 3, 3, 1)):
    """What csrc/styled_up_conv.cu computes. T (B, 2H+1, 2W+1, Cout) row
    Y = 2m + p reads x row m with kernel row 0 and x row m - 1 with kernel
    row 2 (p = 0, m in [0, H]), or x row m with kernel row 1 (p = 1,
    m in [0, H - 1]); the same per column. Then the blur, true
    convolution with pad 1, and the epilogue."""
    xm = x * s[:, None, None, :]
    b, h, wd, _ = xm.shape
    cout = w.shape[3]
    xp = F.pad(xm, (0, 0, 1, 1, 1, 1))  # xp[:, r, c] = xm[:, r - 1, c - 1]
    t = xm.new_zeros(b, 2 * h + 1, 2 * wd + 1, cout)
    for py in (0, 1):
        for px in (0, 1):
            rows, cols = h + 1 - py, wd + 1 - px
            acc = xm.new_zeros(b, rows, cols, cout)
            for ty in range(2 - py):  # 2, 2, 1, 1 ... -> 4, 2, 2, 1 taps
                for tx in range(2 - px):
                    ky, kx = (1 if py else 2 * ty), (1 if px else 2 * tx)
                    patch = xp[:, 1 - ty:1 - ty + rows, 1 - tx:1 - tx + cols]
                    acc = acc + torch.einsum("bhwc,cd->bhwd", patch, w[ky, kx])
            t[:, py::2, px::2] = acc * demod[:, None, None, :]
    k = np.asarray(blur_kernel, np.float32)
    k1 = (np.float32(2.0) * k / k.sum())[::-1]  # flipped: true convolution
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    hz = sum(float(k1[i]) * tp[:, :, i:i + 2 * wd] for i in range(4))
    out = sum(float(k1[i]) * hz[:, i:i + 2 * h] for i in range(4))
    out = out + noise_weight * noise + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


@pytest.mark.parametrize("noise_b", [1, 2])
def test_subpixel_up_conv_phases_match_jax(noise_b):
    rng = np.random.RandomState(4)
    b, h, wd, cin, cout = 2, 3, 5, 8, 12
    args = [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, 2 * h, 2 * wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]
    ours = _np(_subpixel_up_conv(*[_t(a) for a in args]))
    assert ours.shape == (b, 2 * h, 2 * wd, cout)
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(ours, np.asarray(jmc.styled_up_conv3x3_ref(*jargs)),
                               **UP_TOL)
    np.testing.assert_allclose(ours, np.asarray(jmc.styled_up_conv3x3_xla(*jargs)),
                               **UP_TOL)


def _tap_gemm_conv(x, w, s, demod, noise, noise_weight, bias, nsplit=1,
                   stage=32):
    """What csrc/styled_conv.cu computes: out[m, n] = sum over the 9 taps and
    the 32-channel stages of A_tap[m, c] * W_tap[n, c], each stage summed
    from 0 and then added to the running sum; A_tap row m is pixel
    (y + dy - 1, x + dx - 1) of x * s, zero outside the image; W_tap is the
    tap's (Cout, Cin) slice of the (3, 3, Cout, Cin) weights. With the taps
    split nsplit ways, each split's taps 9 z / nsplit .. 9 (z + 1) / nsplit
    have their own running sum, and the splits are added in order. Then
    demod, noise, bias, leaky-ReLU and sqrt(2), in that order."""
    xm = x * s[:, None, None, :]
    b, h, wd, cin = xm.shape
    w_nk = w.permute(0, 1, 3, 2)
    xp = F.pad(xm, (0, 0, 1, 1, 1, 1))  # xp[:, r, c] = xm[:, r - 1, c - 1]
    parts = []
    for z in range(nsplit):
        acc = xm.new_zeros(b * h * wd, w.shape[3])
        for tap in range(9 * z // nsplit, 9 * (z + 1) // nsplit):
            dy, dx = divmod(tap, 3)
            a = xp[:, dy:dy + h, dx:dx + wd].reshape(-1, cin)
            for c0 in range(0, cin, stage):
                acc = acc + a[:, c0:c0 + stage] @ w_nk[dy, dx, :, c0:c0 + stage].T
        parts.append(acc)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    out = acc.reshape(b, h, wd, -1) * demod[:, None, None, :]
    out = out + noise_weight * noise
    out = out + bias
    return torch.where(out >= 0, out, 0.2 * out) * np.sqrt(2.0)


@pytest.mark.parametrize("nsplit", [1, 3, 9])
@pytest.mark.parametrize("noise_b", [1, 3])
def test_tap_gemm_conv_matches_jax(noise_b, nsplit):
    """B * H * W = 105 rows (no multiple of the 128-row tile), Cout = 12,
    Cin = 40: a full 32-channel stage and a partial one per tap; the taps
    whole or split 3 or 9 ways."""
    rng = np.random.RandomState(5)
    b, h, wd, cin, cout = 3, 5, 7, 40, 12
    args = [rng.randn(b, h, wd, cin), rng.randn(3, 3, cin, cout) * 0.05,
            rng.rand(b, cin) + 0.5, rng.rand(b, cout) + 0.5,
            rng.randn(noise_b, h, wd, 1), np.float32(0.3),
            rng.randn(cout) * 0.1]
    ours = _np(_tap_gemm_conv(*[_t(a) for a in args], nsplit=nsplit))
    assert ours.shape == (b, h, wd, cout)
    jargs = [jnp.asarray(np.asarray(a, np.float32)) for a in args]
    np.testing.assert_allclose(ours, np.asarray(jmc.styled_conv3x3_ref(*jargs)),
                               **CONV3_TOL)


@pytest.mark.parametrize("m,cout,want", [
    (8 * 4 * 4, 512, 9), (8 * 16 * 16, 512, 9), (1 * 32 * 32, 512, 3),
    (20 * 8 * 8, 512, 3), (8 * 32 * 32, 512, 1), (8 * 256 * 256, 128, 1),
    (99, 100, 9)])
def test_tap_splits_only_split_an_underfilled_grid(m, cout, want):
    """On 132 SMs: the ffhq layers 4x4 and 16x16 at B = 8, 32x32 at B = 1,
    8x8 at B = 20, two layers that fill the card, and a ragged one."""
    from ganecdotes_torch.ops.modulated_conv import tap_splits

    assert tap_splits(m, cout, 132) == want


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_3xtf32_split_keeps_fp32_accuracy():
    """At the deepest K of the path (9 * 512) and outputs of magnitude ~10,
    the three products of the big and small TF32 parts, summed in fp32, stay
    within the conv tolerance of the fp32 product; the big parts alone
    (plain TF32) do not, which is why the kernel splits."""
    k = 9 * 512
    rng = np.random.RandomState(0)
    a = _t(rng.randn(64, k))
    b = _t(rng.randn(k, 48) * 10 / np.sqrt(k))
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    assert torch.equal(_tf32(a_hi), a_hi) and torch.equal(_tf32(a_lo), a_lo)
    fp32 = a @ b
    assert 5 < float(fp32.abs().max()) < 100
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    torch.testing.assert_close(three, fp32, **CONV_TOL)
    exact = a.double() @ b.double()
    err3 = float((three.double() - exact).abs().max())
    assert err3 <= 2 * float((fp32.double() - exact).abs().max())
    plain = a_hi @ b_hi
    with pytest.raises(AssertionError):
        torch.testing.assert_close(plain, fp32, **CONV_TOL)
    assert float((plain.double() - exact).abs().max()) > 10 * err3


# ---------------------------------------------------------------------------
# the resample adjoint as a gather
# ---------------------------------------------------------------------------


def _geometry(alpha, icpt, v):
    """csrc/affine_warp.cu geometry(): (k0, e1, f), each step one rounded
    float32 operation; broadcasts."""
    U = torch.floor(icpt)
    vfrac = icpt - U
    au = alpha * v
    q = torch.floor(au)
    e_in = (au - q) + vfrac
    e = torch.floor(e_in)
    return U.to(torch.int64) + q.to(torch.int64), e == 1, e_in - e


def _window(alpha, icpt, s_len, v_len):
    """Each (b, s, w)'s candidate rows [v0, v1] of the cotangent: the ends
    (s - 2 - U)/alpha and (s + 1 - U)/alpha (times a rounded 1/alpha),
    widened by one, clipped; all of [0, V) where alpha = 0 or where 1/alpha
    overflows (a subnormal alpha)."""
    s = torch.arange(s_len, dtype=torch.float32)[None, :, None]
    U = torch.floor(icpt)[:, None, :]
    a = alpha[:, None, None]
    inv = 1 / a
    full = (a == 0) | ~torch.isfinite(inv)
    inv = torch.where(full, 0.0, inv)
    e0 = ((s - 2) - U) * inv
    e1 = ((s + 1) - U) * inv
    lo = torch.minimum(e0, e1).clamp(-2, v_len + 1)
    hi = torch.maximum(e0, e1).clamp(-2, v_len + 1)
    v0 = (torch.floor(lo).to(torch.int64) - 1).clamp(min=0)
    v1 = (torch.ceil(hi).to(torch.int64) + 1).clamp(max=v_len - 1)
    full = full.expand_as(v0)
    return torch.where(full, 0, v0), torch.where(full, v_len - 1, v1)


def _gather_adjoint(g, alpha, icpt, s_len):
    """dx[b, c, s, w] = sum over the candidate v of coef_t(v) * g[b, c, v, w],
    t = s - k0(v) in {0, 1, 2}."""
    b, c, v_len, w = g.shape
    v0, v1 = _window(alpha, icpt, s_len, v_len)
    span = int((v1 - v0).max()) + 1
    cand = v0[..., None] + torch.arange(span)  # (B, S, W, L)
    inside = cand <= v1[..., None]
    cand = cand.clamp(max=v_len - 1)
    k0, e1, f = _geometry(alpha[:, None, None, None], icpt[:, None, :, None],
                          cand.to(torch.float32))
    t = torch.arange(s_len)[None, :, None, None] - k0
    one_f = 1 - f
    coef = torch.where(t == 0, torch.where(e1, 0.0, one_f),
                       torch.where(t == 1, torch.where(e1, one_f, f),
                                   torch.where(e1, f, 0.0)))
    coef = torch.where(inside & (t >= 0) & (t <= 2), coef, 0.0)
    gv = g[torch.arange(b)[:, None, None, None, None],
           torch.arange(c)[None, :, None, None, None], cand[:, None],
           torch.arange(w)[None, None, None, :, None]]
    return (coef[:, None] * gv).sum(-1)


@pytest.mark.parametrize("alpha", [None, "neg", 0.0, 0.05, -0.05, 1e-40],
                         ids=["pos", "neg", "zero", "small", "small_neg", "subnormal"])
def test_gather_adjoint_window_and_membership_match_jax(alpha):
    b, c, s_len, w, v_len = 2, 2, 23, 19, 17
    rng = np.random.RandomState(7)
    g = rng.randn(b, c, v_len, w).astype(np.float32)
    a = (rng.rand(b) * 0.6 + 0.7).astype(np.float32)
    icpt = (rng.rand(b, w) * (s_len + 10) - 5).astype(np.float32)
    if alpha is not None and alpha != "neg":
        a = np.full(b, alpha, np.float32)
    if alpha == "neg" or (alpha is not None and alpha != "neg" and alpha < 0):
        a, icpt = -a, (icpt + 0.8 * s_len).astype(np.float32)
    ta, ti = _t(a), _t(icpt)

    # every v whose taps reach s lies in s's window, and they are contiguous
    k0, _, _ = _geometry(ta[:, None, None], ti[:, None, :],
                         torch.arange(v_len, dtype=torch.float32)[None, :, None])
    v0, v1 = _window(ta, ti, s_len, v_len)
    for s in range(s_len):
        hit = (k0 >= s - 2) & (k0 <= s)  # (B, V, W)
        for bb in range(b):
            for ww in range(w):
                vs = torch.nonzero(hit[bb, :, ww]).flatten()
                if len(vs):
                    assert v0[bb, s, ww] <= vs.min() and vs.max() <= v1[bb, s, ww]
                    assert len(vs) == int(vs.max() - vs.min()) + 1

    ours = _gather_adjoint(_t(g), ta, ti, s_len)
    assert ours.shape == (b, c, s_len, w)
    np.testing.assert_allclose(_np(ours), _np(taw._resample_pass_t(_t(g), ta, ti, s_len)),
                               **ADJ_TOL)
    want = jawp.resample_rows_t(jnp.asarray(g), jnp.asarray(a), jnp.asarray(icpt), s_len)
    np.testing.assert_allclose(_np(ours), np.asarray(want), **ADJ_TOL)


# ---------------------------------------------------------------------------
# the Sinkhorn codes, one read of the scores per iteration
# ---------------------------------------------------------------------------

NEG_INIT = -3e38  # csrc/sinkhorn.cu kNegInit


def _merge(m, s, m2, s2):
    """online_merge: (m, s) and (m2, s2) as one (max, sum of exp(z - max))."""
    mx = torch.maximum(m, m2)
    return mx, s * torch.exp(m - mx) + s2 * torch.exp(m2 - mx)


def _fused_sinkhorn(scores, niters, eps, r, c, nchunks):
    """What csrc/sinkhorn.cu computes. The rows fall into nchunks contiguous
    chunks (one block each on the card); a pass reads each row once: pass 0
    folds x / eps into the column accumulators, passes 1 .. niters - 1 first
    take the row's t = lse_k(x / eps + u) and then fold x / eps + log c - t,
    the last pass writes q = exp(x / eps + u - t). Each chunk's column
    (max, sum) partials merge in chunk order into u = log r - lse."""
    b, k = scores.shape
    inv_eps = torch.tensor(1.0 / eps, dtype=torch.float32)
    rows = -(-b // nchunks)
    starts = range(0, b, rows)

    def one_pass(u, kind):
        m = torch.full((k,), NEG_INIT)
        s = torch.zeros(k)
        q = []
        for b0 in starts:
            z = scores[b0:b0 + rows] * inv_eps  # the chunk's one read
            if kind == "first":
                zc = z
            else:
                t = torch.logsumexp(z + u, dim=1, keepdim=True)
                if kind == "last":
                    q.append(torch.exp(z + u - t))
                    continue
                zc = z + (torch.log(c[b0:b0 + rows, None]) - t)
            cm = zc.max(dim=0).values
            m, s = _merge(m, s, cm, torch.exp(zc - cm).sum(dim=0))
        if kind == "last":
            return torch.cat(q)
        return torch.log(r) - (m + torch.log(s))

    u = torch.zeros(k)
    if niters:
        u = one_pass(u, "first")
        for _ in range(1, niters):
            u = one_pass(u, "mid")
    return one_pass(u, "last")


@pytest.mark.parametrize("niters", [0, 1, 3])
def test_fused_sinkhorn_schedule_matches_jax(niters):
    """B = 200 in 7 chunks of 29 rows (the last 26), K = 37 (no multiple of
    4), eps = 0.05, non-uniform marginals."""
    rng = np.random.RandomState(11 + niters)
    b, k, eps = 200, 37, 0.05
    scores = rng.randn(b, k).astype(np.float32)
    r = rng.rand(k).astype(np.float32) + 0.1
    c = rng.rand(b).astype(np.float32) + 0.1
    r, c = r / r.sum(), c / c.sum()
    ours = _fused_sinkhorn(_t(scores), niters, eps, _t(r), _t(c), nchunks=7)
    assert ours.shape == (b, k)
    want = sinkhorn_knopp_pallas(jnp.asarray(scores), niters, eps, jnp.asarray(r),
                                 jnp.asarray(c), variant="fused")
    np.testing.assert_allclose(_np(ours), np.asarray(want), **SINKHORN_TOL)
    ref = sinkhorn_knopp_ref(_t(scores), niters, eps, _t(r), _t(c))
    np.testing.assert_allclose(_np(ours), _np(ref), **SINKHORN_TOL)
    np.testing.assert_allclose(_np(ours).sum(axis=1), 1.0, atol=1e-4)
