"""The port's reference-format loaders held against the JAX package's, on
files the tests write from seeded numpy (no checkpoint ships):

* a rosinality ``g_ema`` state_dict (a bare one and ``{'g_ema': sd}`` in a
  ``.pt``, with and without the noise buffers) through JAX
  ``convert_torch_generator_state`` + ``generator_forward`` and through the
  port's ``load_torch_checkpoint`` + forward, at sizes 32 and 64: the image
  and every feature level within 2e-4 absolute + 1e-4 relative, the
  tolerance of tests/test_torch_generator.py;
* a rosinality Discriminator state_dict, both packages' logits within
  tests/test_torch_discriminator.py's 1e-5 absolute + 1e-4 relative;
* a BagGAN ``*_net_G.pth`` at the reference's lean width map and at the
  rosinality widths: the converted params equal, the forwards within the
  generator tolerance, and the port's export read back by the JAX importer
  equal to the port's own params;
* SwAV's ``prototypes.pt`` / ``projection.pt`` (linear and 2-layer, pickled
  modules and bare state_dicts) and SimCLR's ``projection.pt``: equal
  params in both packages, and the port's ``SwAVClustering`` imports them
  where the JAX one does.

Widths are narrow (a reference checkpoint's widths are read off its keys),
so every forward stays small on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.models.baggan import convert as jbag
from ganecdotes_tpu.models.stylegan2 import convert as jconv
from ganecdotes_tpu.models.stylegan2 import discriminator as jd
from ganecdotes_tpu.models.stylegan2 import generator as jgen
from ganecdotes_tpu.selfsup import simclr as jsimclr
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_torch.models.baggan import convert as tbag
from ganecdotes_torch.models.stylegan2 import convert as tconv
from ganecdotes_torch.models.stylegan2 import discriminator as td
from ganecdotes_torch.models.stylegan2 import generator as tgen
from ganecdotes_torch.ops import _build
from ganecdotes_torch.selfsup import simclr as tsimclr
from ganecdotes_torch.selfsup import swav as tswav
from torch_reference_files import (
    N_MLP,
    NARROW,
    STYLE_DIM,
    modconv_sd,
    randn,
    rosinality_g_ema,
)

GEN_TOL = dict(atol=2e-4, rtol=1e-4)
DISC_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forward_both(jtree, jmeta, g, seed=3):
    rng = np.random.RandomState(seed)
    w = randn(rng, 2, STYLE_DIM)
    mean = randn(rng, 1, STYLE_DIM, scale=0.5)
    img_j, feats_j = jgen.generator_forward(
        jtree, jmeta, [jnp.asarray(w)], input_is_latent=True, truncation=0.7,
        truncation_latent=jnp.asarray(mean), randomize_noise=False)
    _build.reset_launches()
    with torch.no_grad():
        img_t, feats_t = tgen.generator_forward(
            g, torch.from_numpy(w), input_is_latent=True, truncation=0.7,
            truncation_latent=torch.from_numpy(mean))
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU: plain path
    return (img_j, feats_j), (img_t, feats_t)


def _assert_forwards_agree(jout, tout):
    (img_j, feats_j), (img_t, feats_t) = jout, tout
    assert len(feats_t) == len(feats_j)
    for ft, fj in zip(feats_t, feats_j):
        assert tuple(ft.shape) == fj.shape
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **GEN_TOL,
                                   err_msg=f"feature {fj.shape}")
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **GEN_TOL)


# ---------------------------------------------------------------------------
# the rosinality generator and discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,form", [
    (32, "bare"), (32, "g_ema"), (32, "no_noise"),
    (64, "bare"), (64, "g_ema"), (64, "no_noise"),
])
def test_g_ema_checkpoint_matches_jax(tmp_path, size, form):
    sd = rosinality_g_ema(size, seed=size, noises=form != "no_noise")
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = str(tmp_path / "ckpt.pt")
    torch.save({"g_ema": tsd, "latent_avg": torch.zeros(STYLE_DIM)}
               if form == "g_ema" else tsd, path)

    jparams, jmeta = jconv.load_torch_checkpoint(path, size, n_mlp=N_MLP)
    g = tconv.load_torch_checkpoint(path, size, n_mlp=N_MLP)
    # the architecture is read off the state_dict
    assert g.meta["n_latent"] == jmeta["n_latent"]
    assert g.meta["num_layers"] == jmeta["num_layers"]
    assert g.conv1.bias.shape == (NARROW[4],)
    assert g.convs[-1].bias.shape == (NARROW[size],)
    # the converted tree is the JAX one, leaf for leaf
    jflat = dict(tconv._flatten(jax.tree.map(np.asarray, jparams)))
    tflat = {k: v.numpy() for k, v in g.state_dict().items()}
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    if form == "no_noise":
        assert all(not n.any() for n in g.noises)
    _assert_forwards_agree(*_forward_both(jparams, jmeta, g))


def rosinality_discriminator(size, widths=NARROW, seed=0):
    """A rosinality ``Discriminator`` state_dict (numpy): convs.0 the input
    ConvLayer, convs.1..N the ResBlocks, final_conv, final_linear."""
    rng = np.random.RandomState(seed)
    sd = {"convs.0.0.weight": randn(rng, widths[size], 3, 1, 1),
          "convs.0.1.bias": randn(rng, widths[size], scale=0.1)}
    c, r, i = widths[size], size, 1
    while r > 4:
        out = widths[r // 2]
        sd[f"convs.{i}.conv1.0.weight"] = randn(rng, c, c, 3, 3)
        sd[f"convs.{i}.conv1.1.bias"] = randn(rng, c, scale=0.1)
        sd[f"convs.{i}.conv2.1.weight"] = randn(rng, out, c, 3, 3)
        sd[f"convs.{i}.conv2.2.bias"] = randn(rng, out, scale=0.1)
        sd[f"convs.{i}.skip.1.weight"] = randn(rng, out, c, 1, 1)
        c, r, i = out, r // 2, i + 1
    c4 = widths[4]
    sd["final_conv.0.weight"] = randn(rng, c4, c4 + 1, 3, 3)
    sd["final_conv.1.bias"] = randn(rng, c4, scale=0.1)
    sd["final_linear.0.weight"] = randn(rng, c4, c4 * 16)
    sd["final_linear.0.bias"] = randn(rng, c4, scale=0.1)
    sd["final_linear.1.weight"] = randn(rng, 1, c4)
    sd["final_linear.1.bias"] = randn(rng, 1, scale=0.1)
    return sd


@pytest.mark.parametrize("size", [16, 32])
def test_discriminator_state_matches_jax(size):
    sd = rosinality_discriminator(size, seed=size)
    jparams, jmeta = jconv.convert_torch_discriminator_state(
        {k: torch.from_numpy(v) for k, v in sd.items()}, size)
    d = tconv.convert_torch_discriminator_state(sd, size)
    x = randn(np.random.RandomState(1), 4, size, size, 3)
    want = jd.discriminator_forward(jparams, jmeta, jnp.asarray(x))
    with torch.no_grad():
        ours = td.discriminator_forward(d, torch.from_numpy(x))
    assert d.meta == jmeta
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **DISC_TOL)


# ---------------------------------------------------------------------------
# BagGAN
# ---------------------------------------------------------------------------


def baggan_state(size, widths, seed=0, prefix=""):
    """A reference BagGAN ``StyleGANGenerator`` state_dict (numpy), with the
    FIR buffers and the dead mask head its module registers."""
    rng = np.random.RandomState(seed)
    log_size = int(np.log2(size))
    sd = {}
    for i in range(1, N_MLP + 1):
        sd[f"style.mapper.{i}.weight"] = randn(rng, STYLE_DIM, STYLE_DIM)
        sd[f"style.mapper.{i}.bias"] = randn(rng, STYLE_DIM, scale=0.1)
    sd["const_input_block.const_block"] = randn(rng, 1, widths[4], 4, 4)

    def block(p, cin, cout):
        sd.update(modconv_sd(rng, p + ".style_block", cin, cout, 3, "mod"))
        sd[p + ".noise_block.weight"] = np.float32([rng.rand() * 0.5])
        sd[p + ".activation.bias"] = randn(rng, cout, scale=0.1)

    def x_to_img(p, cin):
        sd.update(modconv_sd(rng, p + ".conv", cin, 3, 1, "mod"))
        sd[p + ".bias"] = randn(rng, 1, 3, 1, 1, scale=0.1)

    block("conv_init", widths[4], widths[4])
    x_to_img("x_to_img_init", widths[4])
    cin = widths[4]
    for j, r in enumerate(2**k for k in range(3, log_size + 1)):
        block(f"conv_blks.{2 * j}", cin, widths[r])
        sd[f"conv_blks.{2 * j}.style_block.blur.kernel"] = np.ones((4, 4), np.float32)
        block(f"conv_blks.{2 * j + 1}", widths[r], widths[r])
        x_to_img(f"x_to_img_blks.{j}", widths[r])
        sd[f"x_to_img_blks.{j}.upsample.kernel"] = np.ones((4, 4), np.float32)
        cin = widths[r]
    for li in range((log_size - 2) * 2 + 1):
        r = 2 ** ((li + 5) // 2)
        sd[f"noise_blks.noise_{li}"] = randn(rng, 1, 1, r, r)
    for i in range(4):
        sd[f"head_m.{i}.weight"] = np.zeros((1, 1, 3, 3), np.float32)
        sd[f"head_m.{i}.bias"] = np.zeros((1,), np.float32)
    return {prefix + k: v for k, v in sd.items()}


ROSINALITY_32 = {4: 512, 8: 512, 16: 512, 32: 512}


@pytest.mark.parametrize("widths", ["lean", "rosinality"])
def test_baggan_checkpoint_matches_jax_and_exports_back(tmp_path, widths):
    size = 32
    w = tbag.BAGGAN_RES_TO_CHANNEL_MAP if widths == "lean" else ROSINALITY_32
    assert tbag.BAGGAN_RES_TO_CHANNEL_MAP == jbag.BAGGAN_RES_TO_CHANNEL_MAP
    # a DataParallel save: every key behind "module."
    sd = baggan_state(size, w, seed=7, prefix="module.")
    path = str(tmp_path / "latest_net_G.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)

    jparams, jmeta = jbag.load_baggan_torch_checkpoint(path, size)
    g = tbag.load_baggan_torch_checkpoint(path, size)
    assert g.meta["n_mlp"] == jmeta["n_mlp"] == N_MLP
    assert [c.bias.shape[0] for c in g.convs] == [w[r] for r in (8, 8, 16, 16, 32, 32)]
    jflat = dict(tconv._flatten(jax.tree.map(np.asarray, jparams)))
    tflat = {k: v.numpy() for k, v in g.state_dict().items()}
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    _assert_forwards_agree(*_forward_both(jparams, jmeta, g, seed=8))

    # the port's export: the JAX export's keys and values, and the JAX
    # importer reads it back to the port's own params
    exported = tbag.export_baggan_generator_state(g)
    jexported = jbag.export_baggan_generator_state(jparams)
    assert exported.keys() == jexported.keys()
    for k in exported:
        np.testing.assert_array_equal(exported[k], jexported[k], err_msg=k)
    out = str(tmp_path / "export_net_G.pth")
    tbag.save_baggan_torch_checkpoint(out, g)
    back, _ = jbag.load_baggan_torch_checkpoint(out, size)
    for k, v in dict(tconv._flatten(jax.tree.map(np.asarray, back))).items():
        np.testing.assert_array_equal(v, tflat[k], err_msg=k)


# ---------------------------------------------------------------------------
# SwAV and SimCLR
# ---------------------------------------------------------------------------


HLEN, NCLS, NPROTO = 24, 8, 16


def _swav_modules(projn_nw):
    torch.manual_seed(0)
    if projn_nw == "linear":
        projection = torch.nn.Sequential(torch.nn.Linear(HLEN, NCLS, bias=False))
    else:
        projection = torch.nn.Sequential(
            torch.nn.Linear(HLEN, NCLS, bias=False), torch.nn.BatchNorm1d(NCLS),
            torch.nn.LeakyReLU(inplace=True),
            torch.nn.Linear(NCLS, NCLS, bias=False), torch.nn.BatchNorm1d(NCLS),
            torch.nn.Tanh())
        with torch.no_grad():  # running stats that carry signal
            for bn in (projection[1], projection[4]):
                bn.running_mean.normal_()
                bn.running_var.uniform_(0.5, 2.0)
                bn.weight.normal_()
                bn.bias.normal_()
    return torch.nn.Linear(NCLS, NPROTO), projection


def _assert_trees_equal(ours, want):
    ours = dict(tconv._flatten(ours))
    want = dict(tconv._flatten(jax.tree.map(np.asarray, want)))
    assert ours.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(ours[k]), want[k], err_msg=k)


@pytest.mark.parametrize("projn_nw", ["linear", "2-layer"])
@pytest.mark.parametrize("saved", ["module", "state_dict"])
def test_swav_reference_modules_import_as_jax(tmp_path, projn_nw, saved):
    prototype, projection = _swav_modules(projn_nw)
    pf, jf = str(tmp_path / "prototypes.pt"), str(tmp_path / "projection.pt")
    if saved == "module":  # the reference's torch.save of its modules
        torch.save(prototype, pf)
        torch.save(projection, jf)
    else:
        torch.save(prototype.state_dict(), pf)
        torch.save(projection.state_dict(), jf)
    ours = tswav.import_torch_swav_modules(pf, jf, projn_nw)
    _assert_trees_equal(ours, jswav.import_torch_swav_modules(pf, jf, projn_nw))


def test_swav_clustering_imports_the_reference_files(tmp_path):
    """With train False and no swav_params.npz, the port's SwAVClustering
    imports prototypes.pt / projection.pt from out_dir, as the JAX one does,
    and never pretrains."""
    from test_torch_swav import _clustering_args

    mc, pa, sa, sk = _clustering_args(tmp_path)
    torch.manual_seed(2)
    torch.save(torch.nn.Linear(sa["nclasses"], sa["nprototypes"]),
               str(tmp_path / "prototypes.pt"))
    torch.save(torch.nn.Sequential(
        torch.nn.Linear(sa["hlen"], sa["nclasses"], bias=False)),
        str(tmp_path / "projection.pt"))
    gen = tgen.Generator(16, n_mlp=N_MLP,
                         generator=torch.Generator().manual_seed(0))
    sw = tswav.SwAVClustering(gen, mc, pa, sa, sk, train=False,
                              out_dir=str(tmp_path), device="cpu")
    want = jswav.import_torch_swav_modules(
        str(tmp_path / "prototypes.pt"), str(tmp_path / "projection.pt"),
        "linear")
    _assert_trees_equal(sw.ssl_params, want)
    sw.preprocess(None)
    assert sw.pretrain_count == 0


@pytest.mark.parametrize("saved", ["module", "indexed_state_dict",
                                   "named_state_dict"])
def test_simclr_reference_projection_imports_as_jax(tmp_path, saved):
    torch.manual_seed(1)
    projection = torch.nn.Sequential(
        torch.nn.Linear(HLEN, NCLS, bias=False), torch.nn.BatchNorm1d(NCLS),
        torch.nn.LeakyReLU(inplace=True), torch.nn.Linear(NCLS, NCLS, bias=False))
    with torch.no_grad():
        projection[1].running_mean.normal_()
        projection[1].running_var.uniform_(0.5, 2.0)
        projection[1].weight.normal_()
    path = str(tmp_path / "projection.pt")
    if saved == "module":
        torch.save(projection, path)
    elif saved == "indexed_state_dict":
        torch.save(projection.state_dict(), path)
    else:  # a bare save of named layers: weight, bn.*, lin2.*
        sd = projection.state_dict()
        torch.save({"weight": sd["0.weight"],
                    **{f"bn.{k[2:]}": v for k, v in sd.items() if k.startswith("1.")},
                    "lin2.weight": sd["3.weight"]}, path)
    ours = tsimclr.import_torch_simclr_projection(path)
    _assert_trees_equal(ours, jsimclr.import_torch_simclr_projection(path))
