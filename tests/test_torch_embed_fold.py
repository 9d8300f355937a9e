"""The folded serving projection: the head's first conv folded into the
level-decomposed SwAV projection (``selfsup/embed.py::project_segment_fcn``
and its parts), held against the JAX package's and against the unfused
form.

Tolerances (float32 on both sides, summed in other orders):
``_conv3x3`` within 1e-5 of max |F.conv2d|, ``_polyphase_conv3x3_up``
within 1e-5 of max |conv3x3(nearest-up)|;
``project_segment_fcn`` against JAX 2e-4 absolute + 1e-4 relative on
logits of order 1-10; the folded server against the unfused one: the image
bit-equal (the same synthesis), logits and sample 0's embedding within
1e-4 * max(1, max |unfused|), labels equal on at least 99.9% of pixels
(argmax ties at that precision).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.selfsup import embed as jembed
from ganecdotes_tpu.selfsup.heads import init_one_shot_segmentor
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.models.stylegan2.generator import mapping_apply
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.interp import resize_nearest
from ganecdotes_torch.pipeline.serving import OneShotServer
from ganecdotes_torch.selfsup import embed as tembed
from ganecdotes_torch.selfsup import heads as theads
from ganecdotes_torch.selfsup.swav import swav_predict_from_features

# the feature pyramid of a size-64 StyleGAN2: (resolution, channels)
PYRAMID_64 = [(4, 512)] + [(r, 512) for r in (8, 16, 32, 64) for _ in range(2)]
HEAD_OUT = {"XXS": 12, "XS": 16, "S": 128}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: torch on one thread (a thread pool only adds waits
    when test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 5, 7, 6, 4), (1, 1, 3, 2, 3),
                                   (3, 2, 1, 5, 2), (1, 16, 16, 32, 12)])
def test_conv3x3_is_f_conv2d(shape):
    """The matmul-and-shifted-adds 3x3 conv against F.conv2d (padding 1),
    one-pixel-high and -wide maps included: 1e-5 of max |F.conv2d|."""
    b, h, w_, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, h, w_, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32))
    want = theads.conv2d_dilated_nhwc(x, w, dilation=1, padding=1)
    got = tembed._conv3x3(x, w)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_polyphase_conv_equals_conv_of_the_upsample(f):
    rng = np.random.RandomState(f)
    z = torch.from_numpy(rng.randn(2, 5, 7, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 6, 4).astype(np.float32))
    want = theads.conv2d_dilated_nhwc(resize_nearest(z, (5 * f, 7 * f)), w,
                                      dilation=1, padding=1)
    got = tembed._polyphase_conv3x3_up(z, w, f)
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def _fold_guard_projects(hlen, nclasses, size, h=64):
    """Whether the FLOP guard takes the projected form for the levels above
    the h/4 cutoff (the 32^2 levels at size 64) that ``hlen`` reaches."""
    uses, off = [], 0
    for r, c in PYRAMID_64:
        use = max(0, min(c, hlen - off))
        off += c
        if r == h // 2 and use:
            uses.append(use)
    co, f = HEAD_OUT[size], 2
    fold = sum(9 * u * f * f * co for u in uses)
    proj = sum(u * nclasses for u in uses) + 9 * nclasses * f * f * co
    return bool(uses) and fold > proj


def test_cases_take_both_sides_of_the_fold_guard():
    assert _fold_guard_projects(3000, 16, "XXS")
    assert not _fold_guard_projects(3000, 256, "XXS")
    assert _fold_guard_projects(3000, 256, "S")


@pytest.mark.parametrize("size", ["XXS", "XS", "S"])
@pytest.mark.parametrize("hlen,nclasses", [(3000, 256), (4608, 16)],
                         ids=["cut_mid_32sq", "all_levels_projected"])
def test_project_segment_fcn_matches_jax(size, hlen, nclasses):
    """hlen 3000 cuts a 32^2 level mid-way (above the 16^2 cutoff: folded
    for XXS and XS, projected for S); hlen 4608 with 16 classes takes every
    level, the 64^2 ones folded into the conv, the 32^2 ones projected."""
    rng = np.random.RandomState(hlen + nclasses)
    feats = [rng.randn(1, r, r, c).astype(np.float32) for r, c in PYRAMID_64]
    weight = (rng.randn(hlen, nclasses) / np.sqrt(hlen)).astype(np.float32)
    seg = jax.tree.map(np.asarray, init_one_shot_segmentor(
        jax.random.PRNGKey(len(size)), nclasses, 8, size))
    want = np.asarray(jembed.project_segment_fcn(
        [jnp.asarray(f) for f in feats], jnp.asarray(weight),
        jax.tree.map(jnp.asarray, seg), size, hlen=hlen))
    got = tembed.project_segment_fcn(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(weight),
        from_jax_params(seg), size, hlen=hlen).numpy()
    assert got.shape == want.shape == (1, 64, 64,
                                       theads.segmentor_out_channels(8, size))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    # and the unfused form: project, upsample, head
    unfused = theads.one_shot_segmentor_apply(
        from_jax_params(seg), tembed.project_feature_maps(
            [torch.from_numpy(f) for f in feats], torch.from_numpy(weight),
            hlen=hlen), size).numpy()
    np.testing.assert_allclose(got, unfused, atol=2e-4, rtol=1e-4)


def _server_configs(size, hlen, nclasses):
    classes = ["c%d" % i for i in range(8)]
    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=64,
                         gen_args=dict(size=32, style_dim=512, n_mlp=2),
                         classes=classes)
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(
            hlen=hlen, nclasses=nclasses, nprototypes=32, projn_nw="linear",
            hf_interp="nearest")),
        seg_args=dict(size=size, in_ch=nclasses))
    return mc, sc


@pytest.mark.parametrize("size,hlen,nclasses", [("XXS", 1300, 16),
                                                ("XS", 2000, 256),
                                                ("S", 3584, 16)])
def test_folded_server_matches_unfused_server(size, hlen, nclasses):
    """A size-32 generator (levels 4^2 to 32^2, cutoff 8^2): hlen 1300 cuts
    a coarse level, 2000 a 16^2 one, 3584 takes all, the 32^2 ones folded
    into the conv."""
    mc, sc = _server_configs(size, hlen, nclasses)
    server = OneShotServer(mc, sc, device="cpu", seed=5)
    z = np.random.RandomState(6).randn(2, 512).astype(np.float32)
    _build.reset_launches()
    img, logits, emb0 = server.infer_folded(z)
    u_img, u_logits, u_emb0 = server.infer(z)
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path
    assert torch.equal(img, u_img)
    # z0's embedding: sample 0 projected alone, against its row of the
    # batch's projection (the logits' gate)
    assert (emb0 - u_emb0).abs().max().item() <= \
        1e-4 * max(1.0, u_emb0.abs().max().item())
    scale = max(1.0, u_logits.abs().max().item())
    assert (logits - u_logits).abs().max().item() <= 1e-4 * scale
    # serve on w (the pipeline's test latents) is serve on the z mapping to it
    with torch.no_grad():
        w = mapping_apply(server.gen, torch.from_numpy(z), server.ops)
    w_img, labels, z0 = server.serve(w, input_is_latent=True)
    torch.testing.assert_close(w_img, img, atol=1e-6, rtol=0)
    assert (labels == u_logits.argmax(-1)).float().mean().item() >= 0.999
    assert (z0 == u_emb0.argmax(-1)).float().mean().item() >= 0.999
    # z0 is sample 0's cluster map
    feats = server._synthesize(z, False)[1]
    torch.testing.assert_close(
        emb0, swav_predict_from_features(server.ssl_params,
                                         [f[:1] for f in feats], server.hlen,
                                         server.nclasses), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# RepurposeGAN's folded form: the head over the raw concat
# ---------------------------------------------------------------------------

# tests/test_selfsup.py:711's mixed pyramid (concat 108 wide)
PYRAMID_MIXED = [(4, 24), (8, 24), (8, 24), (16, 12), (16, 12), (32, 6), (32, 6)]


@pytest.mark.parametrize("size", ["XS", "S", "Lin"])
@pytest.mark.parametrize("pyramid,kwargs", [
    (PYRAMID_MIXED, {}), (PYRAMID_MIXED, {"n_layers": 5}),
    (PYRAMID_MIXED, {"hlen": 99}), (PYRAMID_64, {"n_layers": 7}),
], ids=["all", "n_layers_5", "hlen_mid_level", "pyramid_64"])
def test_concat_segment_fcn_matches_unfused_and_jax(size, pyramid, kwargs):
    """XS (16 outputs) takes the level-by-level branch, S (128) the
    materialised concat where the concat is at most 256 wide, Lin the
    projection; the size-64 pyramid's 7 levels (3584 wide, cutoff 16^2)
    lift 4^2 to 16^2 and fold 32^2 polyphase. Against the head over
    ``pixel_feature_maps`` (2e-4 absolute + 1e-4 relative, as
    tests/test_selfsup.py:711) and the JAX form (no Lin branch there)."""
    rng = np.random.RandomState(len(pyramid) + len(kwargs))
    feats = [rng.randn(2, r, r, c).astype(np.float32) for r, c in pyramid]
    n_l, hlen = kwargs.get("n_layers"), kwargs.get("hlen")
    in_ch = sum(c for _, c in pyramid[:n_l]) if hlen is None else hlen
    seg = jax.tree.map(np.asarray, init_one_shot_segmentor(
        jax.random.PRNGKey(4), in_ch, 5, size))
    tf, tseg = [torch.from_numpy(f) for f in feats], from_jax_params(seg)
    got = tembed.concat_segment_fcn(tf, tseg, size, **kwargs)
    x = tembed.pixel_feature_maps(tf, hlen=hlen, n_layers=n_l)
    want = theads.one_shot_segmentor_apply(tseg, x, size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)
    jx = jembed.pixel_feature_maps([jnp.asarray(f) for f in feats], hlen=hlen,
                                   n_layers=n_l)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    if size != "Lin":
        jgot = jembed.concat_segment_fcn(
            [jnp.asarray(f) for f in feats], jax.tree.map(jnp.asarray, seg),
            size, **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-4,
                                   rtol=1e-4)


def test_group_features_by_block_matches_jax():
    from ganecdotes_tpu.selfsup.augmentor import group_features_by_block as jgroup
    from ganecdotes_torch.selfsup.augmentor import group_features_by_block

    rng = np.random.RandomState(9)
    feats = [rng.randn(2, r, r, c).astype(np.float32)
             for r, c in [(4, 3), (8, 2), (8, 4), (16, 5), (16, 1)]]
    tf, jf = [torch.from_numpy(f) for f in feats], [jnp.asarray(f) for f in feats]
    for skip in (False, True):
        got, want = group_features_by_block(tf, skip), jgroup(jf, skip)
        assert len(got) == len(want) == 3 - skip
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        parts, jparts = (group_features_by_block(tf, skip, concat=False),
                         jgroup(jf, skip, concat=False))
        for a, b in zip(parts[skip == 0:], jparts[skip == 0:]):
            assert isinstance(a, tuple) and len(a) == 2
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(pb))
