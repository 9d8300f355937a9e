"""The useful-work counter (``benchmark/flops``) against
``torch.utils.flop_counter.FlopCounterMode`` at a tiny size: over the
plain reference for the mapping and the synthesis, and over the program's
folded head (the served form it counts), with the blurs and the weight-only
folds taken out; and its count of an ffhq-256 request."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from flops import stylegan2_swav_serve as counter
from harness import weights
from reference import stylegan2_swav as ref_mod

CFG = tiny.TINY
B = 3


def flops_of(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def ref():
    w = weights.make(ref_mod.weight_shapes(CFG), CFG, 5, torch.device("cpu"))
    return ref_mod.Reference(CFG, w, torch.device("cpu"))


def test_mapping(ref):
    z = torch.randn(B, CFG["style_dim"])
    assert flops_of(ref.gen.mapping, z) == counter.request(CFG, B)["mapping"]


def test_synthesis_convs_to_rgb_and_modulation(ref):
    w = torch.randn(B, CFG["style_dim"])
    got = flops_of(ref.gen.synthesis, w[:, None].expand(-1, ref.gen.n_latent, -1))
    parts = counter.request(CFG, B)
    ch = counter.channel_map(CFG)
    style = CFG["style_dim"]
    # the reference demodulates elementwise and blurs by shifted adds:
    # neither is a matmul to count
    mod = 2 * style * ch[4] * 2 * B  # conv1 and to_rgb1
    cin = ch[4]
    for j in range(3, int(math.log2(CFG["size"])) + 1):
        c = ch[2 ** j]
        mod += 2 * style * (cin + 2 * c) * B
        cin = c
    assert got == parts["synthesis_convs"] + parts["to_rgb"] + mod


def _features(ref, b):
    w = torch.randn(b, CFG["style_dim"])
    _, feats = ref.gen.synthesis(w[:, None].expand(-1, ref.gen.n_latent, -1))
    return [f.permute(0, 2, 3, 1).contiguous() for f in feats]  # NHWC


def test_folded_head_per_image_as_the_program_computes_it(ref):
    from ganecdotes_torch.selfsup.embed import project_segment_fcn

    w = ref.w
    head = [{"weight": w["head.weight"], "bias": w["head.bias"]}]
    feats = _features(ref, 2)
    one = flops_of(project_segment_fcn, [f[:1] for f in feats],
                   w["projection"], head, "XXS")
    two = flops_of(project_segment_fcn, feats, w["projection"], head, "XXS")
    assert two - one == counter.folded_head(CFG)


def test_sample0_projection(ref):
    from ganecdotes_torch.selfsup.embed import project_feature_maps

    feats = _features(ref, 1)
    got = flops_of(project_feature_maps, feats, ref.w["projection"])
    assert got == counter.request(CFG, B)["projection_sample0"]


def test_an_ffhq256_request():
    import json
    import os

    with open(os.path.join(tiny.BENCH_DIR, "configs", "ffhq256.json")) as f:
        cfg = json.load(f)
    synth = counter.request(cfg, 1)["synthesis_convs"]
    assert 89e9 < synth < 91e9  # 2*9*Cin*Cout a pixel over the 13 convs
    req = counter.request(cfg, 32)
    # the synthesis plus the head's share: the folded head a request and
    # sample 0's projection
    assert req["total"] == pytest.approx(
        32 * synth + req["folded_head"] + req["projection_sample0"], rel=1e-3)
    assert 90e9 * 32 < req["total"] < (90e9 + 25e9) * 32 + 32e9


def test_discriminator_and_generator_forward_of_the_training_count():
    from flops import baggan_train
    from reference import baggan

    cfg = tiny.TINY_TRAIN
    w = weights.make(baggan.weight_shapes(cfg), cfg, 3, torch.device("cpu"))
    t = baggan.Trainer(cfg, w, torch.device("cpu"))
    x = torch.randn(2, 3, cfg["size"], cfg["size"])
    assert flops_of(t.D, x) == 2 * baggan_train.discriminator(cfg)
    lat = torch.randn(2, t.G.n_latent, cfg["style_dim"])
    z = torch.randn(2, cfg["style_dim"])
    got = flops_of(lambda: (t.G.mapping(z), t.G.synthesis(lat)))
    # the reference demodulates elementwise: no matmul to count
    ch = {int(k): v for k, v in cfg["res2chlmap"].items()}
    res = [2 ** j for j in range(3, int(math.log2(cfg["size"])) + 1)]
    demod = 2 * (ch[4] * ch[4] + sum(ch[r // 2] * ch[r] + ch[r] * ch[r] for r in res))
    assert got == 2 * (baggan_train.generator(cfg) - demod)


def test_a_pidray256_iteration():
    import json
    import os

    from flops import baggan_train

    with open(os.path.join(tiny.BENCH_DIR, "configs", "pidray256.json")) as f:
        cfg = json.load(f)
    assert 89e9 < baggan_train.generator(cfg) < 91e9
    assert 92e9 < baggan_train.discriminator(cfg) < 94e9
    avg = sum(baggan_train.iteration(cfg, it)["total"] for it in range(16)) / 16
    assert 30e12 < avg < 40e12
