"""A car-like server on the CPU: the shape of car512's request (StyleGAN2
config-f at 512 with the hfc_with_swav_car segmentor, the XS head) at
64 px. The hlen cut leaves the top level out of the embedding, so no level
is at full resolution: the level below the top takes its own polyphase
conv (f = 2), the coarser ones one polyphase conv (f = 4) at a quarter of
the image, and the XS head's two further convs run at the image size.

The folded form (``serve``) is held against the unfused one
(``serve_unfused``), and both against the benchmark's plain reference of
this request (``benchmark/reference/stylegan2_swav_fcn.py``, loaded by its
path), on the same seeded random weights, with the plain ops (``PLAIN``).

Tolerances (float32 on both sides, summed in other orders): the image
within 1e-5 of max |image|; logits and sample 0's embedding within 1e-4 *
max(1, max |reference|); labels and the cluster map equal on at least
99.9% of the pixels (argmax ties at that precision).
"""

import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

from ganecdotes_torch.models.stylegan2.generator import Generator
from ganecdotes_torch.ops.opset import PLAIN
from ganecdotes_torch.pipeline.serving import OneShotServer

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
# levels 4: 32, 8: 32 x 2, 16: 32 x 2, 32: 16 x 2, 64: 8 x 2; hlen 192 ends
# at 32, as car512's 5376 ends at 256 and leaves 512 out
CFG = {"size": 64, "style_dim": 32, "n_mlp": 2, "channel_multiplier": 2,
       "res2chlmap": {"4": 32, "8": 32, "16": 32, "32": 16, "64": 8},
       "lr_mlp": 0.01, "blur_kernel": [1, 3, 3, 1], "truncation": 0.7,
       "num_latents_for_mean": 64, "label_classes": 8,
       "segmentor": {"projn_nw": "linear", "hf_interp": "nearest", "hlen": 192,
                     "nclasses": 32, "nprototypes": 20, "seg_size": "XS",
                     "head_widths": [16, 8], "head_dilations": [1, 2, 1],
                     "head_out": 8},
       "inference_dtype": "float32"}
SEED = 2**31 + 9


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(server, reference, its mean latent, z): the port's server and the
    plain reference on the benchmark's weights for the seed."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(BENCH_DIR)  # the reference imports its siblings
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        registry = _load(os.path.join(BENCH_DIR, "harness", "registry.py"),
                         "bench_registry")
        ref_mod = registry.load_file(
            os.path.join(BENCH_DIR, "reference", "stylegan2_swav_fcn.py"),
            "bench_reference_stylegan2_swav_fcn")
        weights = registry.load_file(os.path.join(BENCH_DIR, "harness", "weights.py"),
                                     "bench_weights")
        cpu = torch.device("cpu")
        w = weights.make(ref_mod.weight_shapes(CFG), CFG, SEED, cpu)
        ref = ref_mod.Reference(CFG, w, cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        mp.undo()
    seg = CFG["segmentor"]
    gen = Generator(64, style_dim=32, n_mlp=2,
                    res2chlmap={int(k): v for k, v in CFG["res2chlmap"].items()},
                    generator=torch.Generator().manual_seed(0))
    names = set(gen.state_dict())
    gen.load_state_dict({k: v for k, v in w.items() if k in names})
    mc = SimpleNamespace(truncation=0.7, num_latents_for_mean=64,
                         classes=["c%d" % i for i in range(8)])
    sc = SimpleNamespace(
        hfc_prep_args=dict(swav_args=dict(
            hlen=seg["hlen"], nclasses=seg["nclasses"], nprototypes=20,
            projn_nw="linear", hf_interp="nearest")),
        seg_args=dict(size="XS"))
    head = [{"weight": w[f"head.{i}.weight"], "bias": w[f"head.{i}.bias"]}
            for i in range(3)]
    server = OneShotServer(mc, sc, device="cpu", seed=SEED, gen=gen,
                           ssl_params={"projection": [{"weight": w["projection"]}]},
                           seg_params=head, ops=PLAIN)
    # the z the server averages for its mean latent (serving.py's rng(1))
    z_mean = torch.randn(64, 32, generator=torch.Generator().manual_seed(SEED * 4 + 1))
    with torch.no_grad():
        mean_w = ref.mean_latent(z_mean)
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(7))
    return server, ref, mean_w, z


def _close(got, want, scale):
    return (got - want).abs().max().item() <= scale * max(1.0, want.abs().max().item())


def test_the_fold_has_no_full_resolution_level(case):
    """What the folded form meets here, as at car512: the top level is cut
    out, so every used level is coarser than the image."""
    server, _, _, z = case
    with torch.inference_mode():
        _, feats = server._synthesize(z, False)
    hlen, off, used = CFG["segmentor"]["hlen"], 0, []
    for f in feats:
        use = max(0, min(f.shape[-1], hlen - off))
        off += f.shape[-1]
        if use:
            used.append(f.shape[1])
    assert max(used) == 32 and max(f.shape[1] for f in feats) == 64
    assert len(server.seg_params) == 3 and server.foldable


def test_folded_and_unfused_serve_agree(case):
    server, _, _, z = case
    img, logits, emb0 = server.infer_folded(z)
    u_img, u_logits, u_emb0 = server.infer(z)
    assert torch.equal(img, u_img)
    assert _close(logits, u_logits, 1e-4) and _close(emb0, u_emb0, 1e-4)
    _, labels, z0 = server.serve(z)
    _, u_labels, u_z0 = server.serve_unfused(z)
    assert labels.shape == (3, 64, 64) and z0.shape == (1, 64, 64)
    assert (labels == u_labels).float().mean().item() >= 0.999
    assert (z0 == u_z0).float().mean().item() >= 0.999


@pytest.mark.parametrize("form", ["folded", "unfused"])
def test_both_forms_match_the_plain_reference(case, form):
    server, ref, mean_w, z = case
    img, logits, emb0 = (server.infer_folded(z) if form == "folded"
                         else server.infer(z))
    with torch.no_grad():
        r_img, r_logits, r_emb0 = ref.request(z, mean_w, rows=2)
    assert img.shape == r_img.shape == (3, 64, 64, 3)
    assert logits.shape == r_logits.shape == (3, 64, 64, 8)
    assert _close(img, r_img, 1e-5)
    assert _close(logits, r_logits, 1e-4) and _close(emb0[0], r_emb0, 1e-4)
    serve = server.serve if form == "folded" else server.serve_unfused
    _, labels, z0 = serve(z)
    assert (labels == r_logits.argmax(-1)).float().mean().item() >= 0.999
    assert (z0[0] == r_emb0.argmax(-1)).float().mean().item() >= 0.999

