"""The port's StyleGAN2 generator held against the JAX generator.

JAX params from ``init_generator`` (with noise weights and biases set to
random values, so those paths carry signal) are carried across with
``from_jax_generator_params``; both generators then run the same w with
truncation 0.7 toward a mean latent passed in, on the fixed noise buffers.
Tolerance: both run in float32 and differ only in summation order; errors
grow through the layers to ~1e-5 of values of order 1-10, so 2e-4 absolute
plus 1e-4 relative, as tests/test_generator.py holds the JAX generator
against the reference PyTorch one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.stylegan2 import generator as jgen
from ganecdotes_torch.models.stylegan2 import generator as tgen
from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.opset import PLAIN

TOL = dict(atol=2e-4, rtol=1e-4)


def jax_tree(size, seed=0):
    """JAX generator params as numpy, with every noise weight and bias set
    to random values (the JAX init leaves them at zero)."""
    params, meta = jgen.init_generator(jax.random.PRNGKey(seed), size)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for sc in [tree["conv1"], *tree["convs"]]:
        sc["noise_weight"] = np.float32(rng.rand() * 0.5)
        sc["bias"] = (rng.randn(*sc["bias"].shape) * 0.1).astype(np.float32)
    for rgb in [tree["to_rgb1"], *tree["to_rgbs"]]:
        rgb["bias"] = (rng.randn(3) * 0.1).astype(np.float32)
    return tree, meta


def test_generator_meta_matches_jax():
    for size in (32, 256):
        assert tgen.generator_meta(size) == jgen.generator_meta(size)
        assert tgen.num_feature_layers(size) == jgen.num_feature_layers(size)
    assert tgen.channel_map() == jgen.channel_map()


def test_state_dict_names_are_the_jax_tree_paths():
    tree, _ = jax_tree(32)
    shapes = {
        jax.tree_util.keystr(p, simple=True, separator="."): np.shape(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    g = tgen.Generator(32, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in g.state_dict().items()} == shapes


def test_mapping_matches_jax():
    tree, _ = jax_tree(32, seed=1)
    g = from_jax_generator_params(tree)
    z = np.random.RandomState(2).randn(4, 512).astype(np.float32)
    with torch.no_grad():
        ours = tgen.mapping_apply(g, torch.from_numpy(z)).numpy()
    want = np.asarray(jgen.mapping_apply(tree, jnp.asarray(z)))
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [32, 64])
def test_generator_forward_matches_jax(size):
    tree, meta = jax_tree(size, seed=size)
    g = from_jax_generator_params(tree)
    rng = np.random.RandomState(3)
    w = rng.randn(2, 512).astype(np.float32)
    mean = rng.randn(1, 512).astype(np.float32) * 0.5

    img_j, feats_j = jgen.generator_forward(
        tree, meta, [jnp.asarray(w)], input_is_latent=True, truncation=0.7,
        truncation_latent=jnp.asarray(mean), randomize_noise=False)
    _build.reset_launches()
    with torch.no_grad():
        img_t, feats_t = tgen.generator_forward(
            g, torch.from_numpy(w), input_is_latent=True, truncation=0.7,
            truncation_latent=torch.from_numpy(mean))
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path

    assert len(feats_t) == len(feats_j) == tgen.num_feature_layers(size)
    for ft, fj in zip(feats_t, feats_j):
        assert tuple(ft.shape) == fj.shape
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL,
                                   err_msg=f"feature {fj.shape}")
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)


def test_plain_opset_and_explicit_noise_match_jax():
    """z input (mapping inside), explicit per-sample noise, PLAIN op set."""
    tree, meta = jax_tree(32, seed=5)
    g = from_jax_generator_params(tree)
    rng = np.random.RandomState(6)
    z = rng.randn(2, 512).astype(np.float32)
    noise = [rng.randn(2, r, r, 1).astype(np.float32)
             for r in (4, 8, 8, 16, 16, 32, 32)]
    img_j, _ = jgen.generator_forward(
        tree, meta, [jnp.asarray(z)], noise=[jnp.asarray(n) for n in noise],
        randomize_noise=False)
    with torch.no_grad():
        img_t, _ = tgen.generator_forward(
            g, torch.from_numpy(z), noise=[torch.from_numpy(n) for n in noise],
            ops=PLAIN)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)


def test_mean_latent_is_the_mean_of_mapped_z():
    g = tgen.Generator(32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        m = tgen.mean_latent(g, 64, torch.Generator().manual_seed(2))
        z = torch.randn(64, 512, generator=torch.Generator().manual_seed(2))
        want = tgen.mapping_apply(g, z).mean(0, keepdim=True)
    assert m.shape == (1, 512)
    torch.testing.assert_close(m, want)
