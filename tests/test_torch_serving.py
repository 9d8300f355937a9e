"""The port's hfc_with_swav server held against the JAX serving program, and
the port's guards.

The JAX side is the body of the fused ``infer`` of
pipeline/one_shot_pipeline.py:610-629 (generator_forward +
project_segment_fcn + swav_predict_from_features on the first sample) at
size 64 with a small nclasses and an hlen that cuts a pyramid level in the
middle. The port's server computes the same folded form
(``OneShotServer.infer_folded``, behind ``serve``). Tolerance: float32
on both sides, 2e-4 absolute plus 1e-4 relative on values of order 1-10;
argmax labels may differ only where two logits tie to that precision, so at
least 99.9% of pixels must agree.
"""

import ast
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.stylegan2 import generator as jgen
from ganecdotes_tpu.selfsup.embed import project_segment_fcn
from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_tpu.selfsup.heads import init_one_shot_segmentor
from ganecdotes_tpu.selfsup.swav import init_swav_params, swav_predict_from_features
from ganecdotes_torch import ROOT_DIR
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.ops import _build
from ganecdotes_torch.pipeline.serving import OneShotServer
from ganecdotes_torch.selfsup import embed as tembed
from ganecdotes_torch.selfsup import heads as theads
from ganecdotes_torch.selfsup import swav as tswav

TOL = dict(atol=2e-4, rtol=1e-4)
HLEN, NCLASSES, NPROTO = 1300, 16, 32  # hlen cuts the third level (512 ch)


def _configs(size):
    classes = ["c%d" % i for i in range(8)]
    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=64,
                         gen_args=dict(size=size, style_dim=512, n_mlp=8),
                         classes=classes)
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(
            hlen=HLEN, nclasses=NCLASSES, nprototypes=NPROTO,
            projn_nw="linear", hf_interp="nearest")),
        seg_args=dict(size="XXS", in_ch=NCLASSES))
    return mc, sc


def _jax_params(size, seed=0):
    params, meta = jgen.init_generator(jax.random.PRNGKey(seed), size)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for sc in [tree["conv1"], *tree["convs"]]:
        sc["noise_weight"] = np.float32(rng.rand() * 0.5)
        sc["bias"] = (rng.randn(*sc["bias"].shape) * 0.1).astype(np.float32)
    ssl = jax.tree.map(np.asarray, init_swav_params(
        jax.random.PRNGKey(seed + 1), HLEN, NCLASSES, NPROTO, "linear"))
    seg = jax.tree.map(np.asarray, init_one_shot_segmentor(
        jax.random.PRNGKey(seed + 2), NCLASSES, 8, "XXS"))
    return tree, meta, ssl, seg


def test_server_matches_jax_serving_program():
    size = 64
    tree, meta, ssl, seg = _jax_params(size)
    rng = np.random.RandomState(1)
    z = rng.randn(2, 512).astype(np.float32)
    mean = (rng.randn(1, 512) * 0.5).astype(np.float32)

    w = jgen.mapping_apply(tree, jnp.asarray(z))
    img_j, feats = jgen.generator_forward(
        tree, meta, [w], input_is_latent=True, truncation=0.7,
        truncation_latent=jnp.asarray(mean), randomize_noise=False)
    logits_j = project_segment_fcn(feats, jnp.asarray(ssl["projection"][0]["weight"]),
                                   jax.tree.map(jnp.asarray, seg), "XXS", hlen=HLEN)
    z0_j = swav_predict_from_features(jax.tree.map(jnp.asarray, ssl),
                                      [f[:1] for f in feats], HLEN, NCLASSES)

    mc, sc = _configs(size)
    server = OneShotServer(
        mc, sc, device="cpu", gen=from_jax_generator_params(tree),
        ssl_params=from_jax_params(ssl),
        seg_params=from_jax_params(seg), mean_latent=mean)
    _build.reset_launches()
    img, logits, emb0 = server.infer_folded(z)
    _, labels, z0 = server.serve(z)
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path

    assert logits.shape == (2, size, size, 12)  # XXS: 12 channels, quirk kept
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(emb0.numpy(), np.asarray(z0_j), **TOL)
    assert labels.shape == (2, size, size) and z0.shape == (1, size, size)
    assert (labels.numpy() == np.asarray(logits_j).argmax(-1)).mean() >= 0.999
    assert (z0.numpy() == np.asarray(z0_j).argmax(-1)).mean() >= 0.999


def test_projection_equals_explicit_concat():
    """Level-decomposed projection == upsample + concat + matmul, with hlen
    cutting a level in the middle."""
    rng = np.random.RandomState(2)
    feats = [torch.from_numpy(rng.randn(2, r, r, c).astype(np.float32))
             for r, c in [(4, 8), (8, 8), (8, 6), (16, 4)]]
    weight = torch.from_numpy(rng.randn(19, 5).astype(np.float32))
    got = tembed.project_feature_maps(feats, weight, hlen=19)
    want = tembed.pixel_feature_maps(feats, hlen=19) @ weight
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    chunks = tembed._split_weight_by_layer(weight, [8, 8, 6, 4], hlen=19)
    assert chunks == [(0, 8), (8, 8), (16, 3), (22, 0)]


@pytest.mark.parametrize("projn_nw", ["linear", "1-layer", "2-layer"])
def test_swav_projection_matches_jax(projn_nw):
    """Every projection head, with the 2-layer head's train-mode BatchNorm
    (batch statistics at predict time, swav.py:542-546)."""
    ssl = jax.tree.map(np.asarray, init_swav_params(
        jax.random.PRNGKey(3), 20, 6, 10, projn_nw))
    ours_init = tswav.init_swav_params(20, 6, 10, projn_nw)
    assert jax.tree.map(np.shape, ssl) == jax.tree.map(
        lambda t: tuple(t.shape), ours_init)
    rng = np.random.RandomState(3)
    if projn_nw == "2-layer":  # non-trivial affine and running stats
        for bn in (ssl["projection"][1], ssl["projection"][3]):
            for k in bn:
                bn[k] = (rng.rand(6) + 0.5).astype(np.float32)
    feats = [rng.randn(2, r, r, c).astype(np.float32)
             for r, c in [(4, 8), (8, 8), (8, 8)]]
    want = swav_predict_from_features(jax.tree.map(jnp.asarray, ssl),
                                      [jnp.asarray(f) for f in feats], 20, 6,
                                      projn_nw)
    ours = tswav.swav_predict_from_features(
        from_jax_params(ssl), [torch.from_numpy(f) for f in feats], 20, 6,
        projn_nw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    z = rng.randn(2, 3, 3, 6).astype(np.float32)
    for train in (True, False):
        np.testing.assert_allclose(
            tswav.projection_tail(from_jax_params(ssl), torch.from_numpy(z),
                                  projn_nw, train=train).numpy(),
            np.asarray(jswav.projection_tail(jax.tree.map(jnp.asarray, ssl),
                                             jnp.asarray(z), projn_nw,
                                             train=train)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", ["XXS", "XS", "S"])
def test_segmentor_head_matches_jax(size):
    """Head shapes (the XXS zip-truncation quirk included) and apply."""
    seg = jax.tree.map(np.asarray, init_one_shot_segmentor(
        jax.random.PRNGKey(4), 10, 7, size))
    ours_init = theads.init_one_shot_segmentor(10, 7, size)
    assert [tuple(p["weight"].shape) for p in ours_init] == [
        p["weight"].shape for p in seg]
    assert theads.segmentor_out_channels(7, size) == \
        jheads.segmentor_out_channels(7, size)
    x = np.random.RandomState(5).randn(2, 9, 9, 10).astype(np.float32)
    np.testing.assert_allclose(
        theads.one_shot_segmentor_apply(from_jax_params(seg),
                                        torch.from_numpy(x), size).numpy(),
        np.asarray(jheads.one_shot_segmentor_apply(
            jax.tree.map(jnp.asarray, seg), jnp.asarray(x), size)),
        atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _port_files():
    pkg = os.path.join(ROOT_DIR, "ganecdotes_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT_DIR, "chip_smoke.py")
    yield os.path.join(ROOT_DIR, "kernel_ab.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "ganecdotes_tpu", "optax", "flax")
    files = list(_port_files())
    assert len(files) > 10
    for cli in ("evaluate.py", "pretrain.py"):  # the CLIs are covered too
        assert os.path.join(ROOT_DIR, "ganecdotes_torch", "cli", cli) in files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", None)) in ("import_module", "__import__")
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"


def test_server_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OneShotServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        OneShotServer(device="cuda")
    mc, sc = _configs(16)
    _build.reset_launches()
    img, labels, z0 = OneShotServer(mc, sc, device="cpu", seed=3).serve(
        np.random.RandomState(0).randn(2, 512).astype(np.float32))
    assert img.shape == (2, 16, 16, 3) and labels.shape == (2, 16, 16)
    assert z0.shape == (1, 16, 16)
    assert torch.isfinite(img).all()
    assert int(labels.max()) < 12 and int(z0.max()) < NCLASSES
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def test_server_is_deterministic_in_its_seed():
    mc, sc = _configs(16)
    z = np.random.RandomState(4).randn(1, 512).astype(np.float32)
    a = OneShotServer(mc, sc, device="cpu", seed=7).serve(z)[0]
    b = OneShotServer(mc, sc, device="cpu", seed=7).serve(z)[0]
    c = OneShotServer(mc, sc, device="cpu", seed=8).serve(z)[0]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
