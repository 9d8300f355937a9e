"""The port's serving export (runtime/export.py, ops/library.py) on the CPU,
held against the JAX package's (tests/test_export.py) and the live servers.

The artifact keeps the JAX layout (a zip of ``program.bin`` and
``meta.json``); its program runs the four serving kernels as ``ganecdotes``
custom ops, the plain versions on CPU tensors. Tolerances: the artifact
against the port's live server on the same device, image and logits within
1e-6 and labels equal (the same ops in the same order); against the JAX
pipeline's live program with the weights carried across, as
tests/test_torch_serving.py holds the server: image 2e-4 absolute plus
1e-4 relative, labels on 99.9% of pixels.
"""

import json
import os
import textwrap
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.runtime import export as jexport
from ganecdotes_torch.models.stylegan2.convert import (
    from_jax_generator_params,
    from_jax_params,
)
from ganecdotes_torch.models.stylegan2.generator import mapping_apply
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.library import LIBRARY
from ganecdotes_torch.ops.opset import PLAIN
from ganecdotes_torch.ops.upfirdn2d import make_kernel
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
from ganecdotes_torch.pipeline.serving import ConcatServer, OneShotServer
from ganecdotes_torch.runtime.export import export_fn, export_serving, load_exported
from test_pipeline import TINY_KMEANS, TINY_MODEL, TINY_RP, TINY_TRAINER
from test_torch_pipeline import N_TEST, _evaluate_mode, _samples, _write_configs
from test_torch_serving import _configs, _jax_params

TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_export_fn_roundtrip(tmp_path):
    """A plain function exported and loaded back (tests/test_export.py:24),
    and JAX's artifact of the same function agrees."""
    def f(x, y):
        return torch.tanh(x @ y) * 2.0, x.sum(dim=-1)

    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    path = str(tmp_path / "f.ganex")
    meta = export_fn(f, (x, y), path, meta={"kind": "unit"})
    assert meta["kind"] == "unit" and meta["format_version"] == 1
    assert meta["in_shapes"] == [[4, 8], [8, 3]]
    assert meta["out_shapes"] == [[4, 3], [4]]
    assert meta["in_dtypes"] == meta["out_dtypes"] == ["float32"] * 2
    assert meta["platforms"] == ["cuda", "cpu"]
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["meta.json", "program.bin"]

    call, meta2 = load_exported(path)
    assert meta2 == meta
    a, b = call(torch.from_numpy(x), torch.from_numpy(y))
    ea, eb = f(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(a, ea) and torch.equal(b, eb)
    jpath = str(tmp_path / "j.ganex")
    jexport.export_fn(lambda u, v: (jnp.tanh(u @ v) * 2.0, jnp.sum(u, -1)),
                      (x, y), jpath)
    ja, jb = jexport.load_exported(jpath)[0](x, y)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    # moved to a device (here the CPU again) it answers the same
    call_cpu, _ = load_exported(path, device="cpu")
    assert torch.equal(call_cpu(torch.from_numpy(x), torch.from_numpy(y))[0], a)


def test_export_refuses_newer_format(tmp_path):
    path = str(tmp_path / "bad.ganex")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps({"format_version": 999}))
        z.writestr("program.bin", b"")
    with pytest.raises(ValueError, match="format_version"):
        load_exported(path)


def test_library_ops_are_the_plain_versions_on_cpu_and_in_the_program(tmp_path):
    """Each custom op on CPU tensors equals its plain version bit for bit
    and launches nothing; the exported request (latents w) holds the three
    synthesis ops, traced through their fake shapes at 32^2, and an
    exported mapping of z the fused act's."""
    rs = np.random.RandomState(2)
    t = lambda *s: torch.from_numpy(np.asarray(rs.randn(*s), np.float32))  # noqa: E731
    x, b = t(2, 8, 8, 16), t(16)
    _build.reset_launches()
    assert torch.equal(LIBRARY.fused_leaky_relu(x, b), PLAIN.fused_leaky_relu(x, b))
    k = make_kernel([1, 3, 3, 1], 4)
    for up, down, pad in ((2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (1, 2))):
        assert torch.equal(LIBRARY.upfirdn2d(x, k, up, down, pad),
                           PLAIN.upfirdn2d(x, k, up, down, pad))
    args = (x, t(3, 3, 16, 8), t(2, 16), t(2, 8), t(1, 8, 8, 1), t(), t(8))
    assert torch.equal(LIBRARY.styled_conv3x3(*args), PLAIN.styled_conv3x3(*args))
    up_args = args[:4] + (t(2, 16, 16, 1),) + args[5:]
    assert torch.equal(LIBRARY.styled_up_conv3x3(*up_args),
                       PLAIN.styled_up_conv3x3(*up_args))
    assert all(v == 0 for v in _build.LAUNCHES.values())

    mc, sc = _configs(32)
    server = OneShotServer(mc, sc, device="cpu", seed=0)
    path = str(tmp_path / "s.ganex")
    meta = export_serving(server, path, batch=2)
    assert meta["segmentor"] == "hfc_with_swav" and meta["sm_count"] is None
    assert meta["out_shapes"] == [[2, 32, 32, 3], [2, 32, 32], [1, 32, 32]]
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(__import__("io").BytesIO(z.read("program.bin")))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    for op in ("upfirdn2d", "styled_conv3x3", "styled_up_conv3x3"):
        assert f"ganecdotes.{op}.default" in targets, op
    call, _ = load_exported(path)
    w = torch.randn(2, 512, generator=torch.Generator().manual_seed(3))
    for got, want in zip(call(w), server.serve(w, input_is_latent=True)):
        assert torch.equal(got, want)
    # the request takes w: kernel 1 runs in the mapping of z only
    mpath = str(tmp_path / "m.ganex")
    export_fn(lambda z: mapping_apply(server.gen, z, LIBRARY), (w,), mpath)
    with zipfile.ZipFile(mpath) as z:
        program = torch.export.load(__import__("io").BytesIO(z.read("program.bin")))
    assert any(str(n.target) == "ganecdotes.fused_leaky_relu.default"
               for n in program.graph.nodes)
    assert torch.equal(load_exported(mpath)[0](w), mapping_apply(server.gen, w, PLAIN))


def _jax_tiny_pipeline(tmp_path):
    from ganecdotes_tpu.pipeline.one_shot_pipeline import OneShotPipeline as JaxPipeline

    cfg = {}
    for name, body in [("model", TINY_MODEL), ("trainer", TINY_TRAINER),
                       ("rp", TINY_RP)]:
        p = tmp_path / f"{name}_config.py"
        p.write_text(textwrap.dedent(body))
        cfg[name] = str(p)
    pipe = JaxPipeline(out_dir=str(tmp_path / "out"), model="ffhq-256",
                       segmentor="repurposegan", num_test_samples=2,
                       custom={"model": cfg["model"], "trainer": cfg["trainer"],
                               "seg": cfg["rp"]})
    pipe.run_pipeline()
    return pipe


def test_export_serving_matches_live_server_and_jax_pipeline(tmp_path):
    """tests/test_export.py:82's case: JAX's tiny trained RepurposeGAN
    pipeline; the port's server over its generator, mean latent and trained
    head, exported with batch 3. The artifact against that live server
    (1e-6, labels equal) and against the JAX pipeline's live program."""
    jpipe = _jax_tiny_pipeline(tmp_path)
    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    mean = from_jax_params(np.asarray(jpipe.mean_latent))
    seg = from_jax_params(jax.tree.map(np.asarray, jpipe.segmentor_params))
    server = ConcatServer(gen, mean, jpipe.model_config.truncation, seg, "XS",
                          n_layers=7, ops=PLAIN)
    path = str(tmp_path / "serving.ganex")
    meta = export_serving(server, path, batch=3)
    assert meta["kind"] == "one_shot_serving" and meta["segmentor"] == "repurposegan"
    assert meta["batch"] == 3 and meta["latent_dim"] == 512
    assert meta["out_shapes"] == [[3, 32, 32, 3], [3, 32, 32]]

    latents = np.array(jax.random.normal(jax.random.PRNGKey(7), (3, 512)))
    w = torch.from_numpy(latents)
    call, _ = load_exported(path)
    img, pred = call(w)
    live_img, live_pred, _ = server.serve(w, input_is_latent=True)
    scale = max(1.0, live_img.abs().max().item())
    assert (img - live_img).abs().max().item() <= 1e-6 * scale
    assert torch.equal(pred, live_pred)

    j_img, j_pred = jpipe._make_infer_fn()(
        jpipe.model.params, jpipe.segmentor_params, jnp.asarray(latents))
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), **TOL)
    assert (pred.numpy() == np.asarray(j_pred)).mean() >= 0.999


def test_export_serving_of_the_hierarchical_kmeans_pipeline(tmp_path):
    """``export_serving`` of a trained pipeline (its method's server): the
    tiny hfc_kmeans pipeline with the hierarchical clusterer and the
    belief encoding, evaluated on saved clusterers; the artifact against
    the pipeline's live server, labels equal."""
    seg = TINY_KMEANS.replace("hfc_algo='hfc_kmeans'", "hfc_algo='hfc_kmeans_hier'")
    seg = seg.replace("hier_encode=False", "hier_encode=True")
    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)), seg=seg)
    out = str(tmp_path / "o")
    os.makedirs(out)
    rs = np.random.RandomState(14)
    for n, k in enumerate((4, 8)):
        np.savez_compressed(os.path.join(out, f"clusterer_layer_{n}.npz"),
                            centers=(rs.randn(k, 1024) * 0.5).astype(np.float32))
    pipe = OneShotPipeline(out_dir=out, model="ffhq-256", segmentor="hfc_kmeans",
                           num_test_samples=N_TEST, custom=cfg, device="cpu")
    _evaluate_mode(pipe)
    pipe.run_pipeline()
    path = str(tmp_path / "k.ganex")
    meta = export_serving(pipe, path)
    assert meta["segmentor"] == "hfc_kmeans" and meta["batch"] == 8
    assert meta["classes"] == list(pipe.model_config.classes)
    call, _ = load_exported(path)
    w = torch.as_tensor(np.repeat(pipe.test_latents[:2], 4, axis=0))
    img, pred = call(w)
    live_img, live_pred, _ = pipe.server.serve(w, input_is_latent=True)
    assert torch.equal(img, live_img) and torch.equal(pred, live_pred)
