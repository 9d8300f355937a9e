"""bfloat16 in the port, held against the JAX package's bfloat16 on the CPU:
the kernels' plain versions, the generator, serving with the model
config's ``inference_dtype = 'bfloat16'`` (the folded and unfused server
and the exported program; every method's pipeline in
tests/test_torch_bf16_pipeline.py), and BagGAN with ``compute_dtype =
'bfloat16'`` (the D, G, R1 and PPL steps, whole iterations, data parallel).

The types follow the JAX programs' own, read from ``jax.make_jaxpr`` of
the bf16 ``generator_forward`` at a tiny config on the CPU:

* the mapping and the truncation run in float32; the w+ rows and the
  constant input are cast to bf16;
* the styles s and demod come out in bf16: ``equal_linear_apply`` casts its
  float32 weight to the latent's bf16 (and ``w_sq`` is cast to s's type
  before the demod product); every conv casts its float32 master weight to
  the activation's type (``conv2d_nhwc``);
* the noise weight, the noise maps and the biases are cast to bf16 where
  they meet the activation; the blur taps (0.25, 0.75) are exact in bf16;
* the serving projections and heads cast their float32 weights to the
  features' bf16 (``project_feature_maps``, the folds), except where a JAX
  op multiplies a bf16 tensor by a float32 array, which promotes to
  float32 in both packages (SimCLR's BatchNorm affine);
* in training, D's predictions are cast to float32 before the losses, the
  gradient penalty's interpolates to float32 (its D runs in float32), and
  R1 and PPL stay float32; the D step's image comes back in float32.

Tolerance. Both packages round to bf16, at different places (JAX folds
scalar constants to bf16 before it multiplies, torch multiplies in float32
and rounds once; the port's composites and JAX's fuse differently). So the
tolerance comes from bf16 itself: the port's bf16 output may differ from
JAX's bf16 output by at most ``BF16_FACTOR`` (2) times JAX's own bf16
against float32 difference on the same input, each test comparing the
largest absolute differences. Labels: the port's bf16 labels against
JAX's bf16 labels and against the port's own float32 labels, at JAX's
gate for bf16 against float32 (>= 95%, tests/test_pipeline.py:383-389).

Measured here, |port - JAX| / |JAX bf16 - JAX float32| (largest absolute
differences): the StyledConvs' plain versions 0.98 (conv), 1.04 / 0.78
(up: sub-pixel / conv_transpose + blur); the fused act 0.46, its VJP's
dx 0.01 and db 0.05; the FIR 1.01 (blur), 1.06 (up 2), 0.00 (SYM6 down);
the warp pass 0.00, its adjoint 1.61; the generator's image and seven
feature maps 0.95-1.57; the server's image 1.22, folded logits 1.15,
unfused logits 0.82, sample 0's embedding 1.03; the D step's loss 0.13
and gradient (L2) 0.56, the G step's 1.06 and 0.28.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.ops import _build
from test_torch_pipeline import one_torch_thread  # noqa: F401  (the autouse fixture)

BF16_FACTOR = 2.0
LABEL_GATE = 0.95  # JAX's own bf16-against-float32 gate


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def assert_bf16_close(port16, jax16, jax32, name=""):
    """|port bf16 - JAX bf16| <= BF16_FACTOR * |JAX bf16 - JAX float32|
    (largest absolute differences); returns the two numbers."""
    got, own = _max_diff(port16, jax16), _max_diff(jax16, jax32)
    assert got <= BF16_FACTOR * own, (name, got, own)
    return got, own


# ---------------------------------------------------------------------------
# the kernels' plain versions in bf16
# ---------------------------------------------------------------------------

bf = torch.bfloat16


def _styled_args(rng, b, h, w, ci, co, up):
    """StyledConv operands as the bf16 generator gives them: x, s and demod
    bf16, W, the noise maps, the noise weight and the bias float32."""
    f = 2 if up else 1
    x = rng.randn(b, h, w, ci).astype(np.float32)
    wt = (rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
    s = (1 + 0.3 * rng.randn(b, ci)).astype(np.float32)
    demod = (1 / np.sqrt((s ** 2) @ (wt ** 2).sum((0, 1)) + 1e-8)).astype(np.float32)
    noise = rng.randn(1, f * h, f * w, 1).astype(np.float32)
    nw = np.float32(0.3)
    bias = (0.1 * rng.randn(co)).astype(np.float32)
    return [x, wt, s, demod, noise, nw, bias]


def _as(args, kinds, to):
    """The operands in ``to``'s arrays, x, s and demod (``kinds``) cast."""
    return [to(a, k in kinds) for a, k in zip(args, "xwsdnmb")]


def _jax(a, cast):
    a = jnp.asarray(a)
    return a.astype(jnp.bfloat16) if cast else a


def _torch(a, cast):
    t = torch.as_tensor(np.asarray(a))
    return t.to(bf) if cast else t


@pytest.mark.parametrize("up", [False, True], ids=["conv", "up"])
def test_styled_conv_plain_bf16_matches_jax(up):
    """Kernels 3 and 4's plain versions in bf16 (the sub-pixel form and the
    conv_transpose + blur one for the up body) against JAX's
    ``styled_conv3x3_ref`` / ``styled_up_conv3x3_xla`` in bf16, as its
    generator runs them (the Pallas kernel has no CPU mode)."""
    from ganecdotes_tpu.ops import modulated_conv_pallas as jmc
    from ganecdotes_torch.ops import modulated_conv as tmc

    args = _styled_args(np.random.RandomState(1), 2, 8, 8, 16, 24, up)
    jfn = jmc.styled_up_conv3x3_xla if up else jmc.styled_conv3x3_ref
    want16 = np.asarray(jfn(*_as(args, "xsd", _jax)).astype(jnp.float32))
    want32 = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    t16 = _as(args, "xsd", _torch)
    ports = ([tmc.styled_up_conv3x3_ref, tmc.styled_up_conv3x3_xla] if up
             else [tmc.styled_conv3x3_ref])
    for fn in ports:
        got = fn(*t16)
        assert got.dtype == bf
        assert_bf16_close(got.float().numpy(), want16, want32, fn.__name__)
    # the wrappers take the plain versions on the CPU, in bf16 too
    wrapped = (tmc.styled_up_conv3x3 if up else tmc.styled_conv3x3)(*t16)
    assert torch.equal(wrapped, ports[0](*t16))


def test_fused_act_and_its_vjp_bf16_match_jax():
    """Kernel 1 and its backward (row 1-bwd) in bf16: the port's Functions
    on the CPU against ``fused_leaky_relu_pallas`` in interpret mode and
    its ``jax.vjp``, the bias float32 cast to bf16 as both do."""
    from ganecdotes_tpu.ops.fused_act import fused_leaky_relu_pallas
    from ganecdotes_torch.ops import fused_act as tfa

    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    b = (0.3 * rng.randn(12)).astype(np.float32)
    g = rng.randn(2, 6, 6, 12).astype(np.float32)

    def jax_side(cast):
        xx = _jax(x, cast)
        y, vjp = jax.vjp(lambda xv, bv: fused_leaky_relu_pallas(xv, bv), xx, jnp.asarray(b))
        dx, db = vjp(_jax(g, cast))
        return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, db)]

    w16, w32 = jax_side(True), jax_side(False)
    xt = torch.as_tensor(x).to(bf).requires_grad_(True)
    bt = torch.as_tensor(b).requires_grad_(True)
    y = tfa.fused_leaky_relu(xt, bt)
    dx, db = torch.autograd.grad(y, (xt, bt), torch.as_tensor(g).to(bf))
    assert y.dtype == dx.dtype == bf and db.dtype == torch.float32
    for got, a, c, name in zip((y, dx, db), w16, w32, ("y", "dx", "db")):
        assert_bf16_close(got.detach().float().numpy(), a, c, name)
    dx2, db2 = tfa.fused_leaky_relu_bwd(torch.as_tensor(g).to(bf), y.detach())
    assert dx2.dtype == db2.dtype == bf and torch.equal(dx2, dx)


@pytest.mark.parametrize("case", ["blur", "up2", "sym6_down"])
def test_upfirdn2d_bf16_matches_jax(case):
    """Kernel 2's plain version in bf16 against JAX's upfirdn2d in bf16
    (the blur through its Pallas kernel in interpret mode): D's blur, the
    to_rgb upsample, one of ADA's SYM6 down passes."""
    from ganecdotes_tpu.gan.ada import SYM6
    from ganecdotes_torch.ops import upfirdn2d as tup

    jup = importlib.import_module("ganecdotes_tpu.ops.upfirdn2d")

    rng = np.random.RandomState(3)
    if case == "blur":
        x, k = rng.randn(2, 9, 9, 8), tup.make_kernel((1, 3, 3, 1))
        kw = dict(up=1, down=1, pad=(2, 2))
    elif case == "up2":
        x, k = rng.randn(2, 8, 8, 3), tup.make_kernel((1, 3, 3, 1), gain=4)
        kw = dict(up=2, down=1, pad=(2, 1))
    else:
        x, k = rng.randn(2, 20, 20, 3), np.asarray(SYM6, np.float32)[None, ::-1]
        kw = dict(up=1, down=(2, 1), pad=(3, 2, 0, 0))
    x = x.astype(np.float32)
    k = np.ascontiguousarray(k, np.float32)
    want16 = np.asarray(jup.upfirdn2d(jnp.asarray(x).astype(jnp.bfloat16), k, **kw)
                        .astype(jnp.float32))
    want32 = np.asarray(jup.upfirdn2d(jnp.asarray(x), k, **kw))
    got = tup.upfirdn2d(torch.as_tensor(x).to(bf), k, **kw)
    assert got.dtype == bf
    assert_bf16_close(got.float().numpy(), want16, want32, case)


def test_resample_rows_bf16_match_jax_pallas_interpret():
    """Kernels 6a and 6b's plain versions in bf16 against JAX's Pallas
    ``resample_rows`` in interpret mode and its VJP (the adjoint)."""
    from ganecdotes_tpu.ops import affine_warp_pallas as jawp
    from ganecdotes_torch.ops import resample as trs

    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 24, 16).astype(np.float32)
    alpha = np.array([0.9, -1.1], np.float32)
    icpt = (rng.rand(2, 16) * 20).astype(np.float32)
    g = rng.randn(2, 3, 20, 16).astype(np.float32)

    def jax_side(cast):
        y, vjp = jax.vjp(lambda xv: jawp.resample_rows(xv, jnp.asarray(alpha),
                                                       jnp.asarray(icpt), 20),
                         _jax(x, cast))
        (dx,) = vjp(_jax(g, cast))
        return [np.asarray(t.astype(jnp.float32)) for t in (y, dx)]

    w16, w32 = jax_side(True), jax_side(False)
    y = trs.resample_rows(torch.as_tensor(x).to(bf), torch.as_tensor(alpha),
                          torch.as_tensor(icpt), 20)
    dx = trs.resample_rows_t(torch.as_tensor(g).to(bf), torch.as_tensor(alpha),
                             torch.as_tensor(icpt), 24)
    assert y.dtype == dx.dtype == bf
    assert_bf16_close(y.float().numpy(), w16[0], w32[0], "resample_rows")
    assert_bf16_close(dx.float().numpy(), w16[1], w32[1], "resample_rows_t")


def test_kernels_refuse_types_they_do_not_take():
    """On a CUDA tensor a type the kernels do not take raises naming the
    kernel (the check runs before anything launches; no card needed to
    reach it, the tensor's type is read first)."""
    for dtype in (torch.float16, torch.float64):
        t = torch.zeros(2, dtype=dtype)
        with pytest.raises(TypeError, match="styled_conv3x3: x is"):
            _build.kernel_dtype("styled_conv3x3", t)
    assert _build.kernel_dtype("upfirdn2d", torch.zeros(1, dtype=bf)) is bf
    assert _build.entry("gk_upfirdn2d", bf) == "gk_upfirdn2d_bf16"
    assert all(k + "_bf16" in _build.LAUNCHES for k in _build.BF16_KERNELS)


# ---------------------------------------------------------------------------
# the generator and the server
# ---------------------------------------------------------------------------


def test_generator_forward_bf16_matches_jax():
    """``generator_forward(dtype=bfloat16)`` against JAX's, image and every
    feature map, at a 32^2 generator with random noise weights and biases
    (tests/test_torch_generator.py's tree); the mapping in float32 on both
    sides."""
    from ganecdotes_tpu.models.stylegan2 import generator as jgen
    from ganecdotes_torch.models.stylegan2 import generator as tgen
    from ganecdotes_torch.ops.opset import PLAIN
    from test_torch_generator import jax_tree

    tree, meta = jax_tree(32, seed=5)
    g = from_jax_generator_params(tree)
    rng = np.random.RandomState(6)
    w = rng.randn(2, 512).astype(np.float32)
    mean = (rng.randn(1, 512) * 0.5).astype(np.float32)

    def jax_side(dtype):
        img, feats = jgen.generator_forward(
            tree, meta, [jnp.asarray(w)], input_is_latent=True, truncation=0.7,
            truncation_latent=jnp.asarray(mean), randomize_noise=False, dtype=dtype)
        return [np.asarray(t.astype(jnp.float32)) for t in [img, *feats]]

    w16, w32 = jax_side(jnp.bfloat16), jax_side(None)
    with torch.no_grad():
        img, feats = tgen.generator_forward(
            g, [torch.as_tensor(w)], input_is_latent=True, truncation=0.7,
            truncation_latent=torch.as_tensor(mean), ops=PLAIN, dtype=bf)
    outs = [img, *feats]
    assert all(t.dtype == bf for t in outs)
    for i, (got, a, c) in enumerate(zip(outs, w16, w32)):
        assert_bf16_close(got.float().numpy(), a, c, f"output {i}")


def _bf16_server(size=64):
    from ganecdotes_torch.models.stylegan2.convert import from_jax_params
    from ganecdotes_torch.pipeline.serving import OneShotServer
    from test_torch_serving import _configs, _jax_params

    tree, meta, ssl, seg = _jax_params(size)
    mean = (np.random.RandomState(1).randn(1, 512) * 0.5).astype(np.float32)
    mc, sc = _configs(size)
    server = OneShotServer(mc, sc, device="cpu", gen=from_jax_generator_params(tree),
                           ssl_params=from_jax_params(ssl),
                           seg_params=from_jax_params(seg), mean_latent=mean,
                           dtype="bfloat16")
    return server, (tree, meta, ssl, seg, mean)


def test_folded_bf16_server_matches_jax_bf16_program():
    """OneShotServer with dtype 'bfloat16' against JAX's bf16 folded program
    (one_shot_pipeline.py:610-629 with ``dtype``): the image, the folded
    logits and sample 0's embedding; and the unfused form against JAX's
    unfused program (projection, then the head)."""
    from ganecdotes_tpu.models.stylegan2 import generator as jgen
    from ganecdotes_tpu.selfsup.embed import project_segment_fcn
    from ganecdotes_tpu.selfsup.heads import one_shot_segmentor_apply
    from ganecdotes_tpu.selfsup.swav import swav_predict_from_features
    from test_torch_serving import HLEN as S_HLEN
    from test_torch_serving import NCLASSES as S_NCLASSES

    server, (tree, meta, ssl, seg, mean) = _bf16_server()
    z = np.random.RandomState(2).randn(2, 512).astype(np.float32)
    jssl, jseg = jax.tree.map(jnp.asarray, ssl), jax.tree.map(jnp.asarray, seg)

    def jax_side(dtype):
        w = jgen.mapping_apply(tree, jnp.asarray(z))
        img, feats = jgen.generator_forward(
            tree, meta, [w], input_is_latent=True, truncation=0.7,
            truncation_latent=jnp.asarray(mean), randomize_noise=False, dtype=dtype)
        folded = project_segment_fcn(feats, jssl["projection"][0]["weight"], jseg,
                                     "XXS", hlen=S_HLEN)
        emb = swav_predict_from_features(jssl, feats, S_HLEN, S_NCLASSES)
        unfused = one_shot_segmentor_apply(jseg, emb, "XXS")
        return [np.asarray(t.astype(jnp.float32)) for t in (img, folded, emb[:1], unfused)]

    w16, w32 = jax_side(jnp.bfloat16), jax_side(None)
    img, logits, emb0 = server.infer_folded(z)
    _, u_logits, u_emb0 = server.infer(z)
    assert img.dtype == logits.dtype == bf
    for got, k, name in ((img, 0, "image"), (logits, 1, "folded logits"),
                         (emb0, 2, "embedding"), (u_logits, 3, "unfused logits"),
                         (u_emb0, 2, "unfused embedding")):
        assert_bf16_close(got.float().numpy(), w16[k], w32[k], name)
    labels = server.serve(z)[1].numpy()
    assert (labels == w16[1].argmax(-1)).mean() >= LABEL_GATE


def test_bf16_server_exports_and_serves_as_live(tmp_path):
    """The export of the bf16 server (``runtime.export.export_serving``):
    the program loads, runs in bf16 (its custom ops on the plain versions
    on the CPU) and answers the request as the live server does."""
    from ganecdotes_torch.runtime.export import export_serving, load_exported

    server, _ = _bf16_server(32)
    path = str(tmp_path / "bf16.ganex")
    meta = export_serving(server, path, batch=2)
    assert meta["out_dtypes"][0] == "bfloat16"
    w = torch.as_tensor(np.random.RandomState(3).randn(2, 512).astype(np.float32))
    call, _ = load_exported(path)
    img, labels, z0 = call(w)
    live = server.serve(w, input_is_latent=True)
    assert img.dtype == bf and torch.equal(img, live[0])
    assert torch.equal(labels, live[1]) and torch.equal(z0, live[2])


# ---------------------------------------------------------------------------
# BagGAN with compute_dtype = 'bfloat16'
# ---------------------------------------------------------------------------


def _jax_bf16_steps(meta, d_meta, cfg, real, zs, inject, p):
    """The JAX trainer's D and G losses under ``compute_dtype`` (None or
    bf16) as functions of the params, as train.py:392-526 composes them:
    the synthesis in that type, the real batch cast before ADA, D's
    predictions cast to float32, the penalty's interpolates in float32."""
    from ganecdotes_tpu.gan import ada as jada
    from ganecdotes_tpu.gan import losses as jl
    from ganecdotes_tpu.models.stylegan2 import discriminator as jd
    from ganecdotes_tpu.models.stylegan2 import generator as jg

    n_latent = meta["n_latent"]
    adv = jl.gan_loss(cfg.gan_mode)

    def steps(dtype):
        def synth(gp, key):
            ws = [jg.mapping_apply(gp, z) for z in zs]
            rows = jnp.arange(n_latent)[None, :, None]
            lat = (jnp.repeat(ws[0][:, None, :], n_latent, axis=1) if len(ws) == 1
                   else jnp.where(rows < inject, ws[0][:, None, :], ws[1][:, None, :]))
            return jg.generator_forward(gp, meta, [lat], input_is_latent=True,
                                        randomize_noise=True, noise_key=key,
                                        return_latents=True, dtype=dtype)[0]

        def aug(x, key):
            return jada.augment(x, p, key, warp_impl="shear")[0] if cfg.augment else x

        def d32(dp, x):
            return jd.discriminator_forward(dp, d_meta, x).astype(jnp.float32)

        def d_loss(dp, gp, key):
            kz, kd = jax.random.split(key)
            fake = jax.lax.stop_gradient(synth(gp, kz))
            k1, k2, k3 = jax.random.split(kd, 3)
            d_real = real if dtype is None else real.astype(dtype)
            d_fake, d_real = aug(fake, k1), aug(d_real, k2)
            lo, lr_ = adv(d32(dp, d_fake), False), adv(d32(dp, d_real), True)
            gp_, _ = jl.gradient_penalty(lambda x: jd.discriminator_forward(dp, d_meta, x),
                                         d_real.astype(jnp.float32),
                                         d_fake.astype(jnp.float32), k3)
            return (lo + lr_) * 0.25 + gp_ * 0.5

        def g_loss(gp, dp, key):
            kz, ka = jax.random.split(key)
            return adv(d32(dp, aug(synth(gp, kz), ka)), True)

        return d_loss, g_loss

    return steps(jnp.bfloat16), steps(None)


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float64).ravel() for g in grads])


@pytest.mark.parametrize("kind", ["d", "g", "r1", "ppl"])
def test_bf16_steps_match_jax_bf16_steps(tmp_path, kind):
    """Each step kind with ``compute_dtype='bfloat16'`` from the JAX nets'
    weights and the JAX steps' draws (tests/test_torch_gan.py's harness):
    the D and G steps against JAX's bf16 steps, the loss and the whole
    gradient (the parameters' concatenated) within BF16_FACTOR times JAX's
    own bf16-vs-float32 difference; R1 and PPL, float32 in both packages
    whatever compute_dtype, against JAX's float32 steps at
    tests/test_torch_gan.py's tolerances."""
    import test_torch_gan as tg_
    from ganecdotes_tpu.models.stylegan2 import discriminator as jd
    from test_torch_discriminator import disc_tree

    g_params, meta = tg_._jax_generator()
    d_tree = disc_tree(seed=4, widths=tg_.WIDTHS)
    rng = np.random.RandomState(5)
    real = rng.randn(tg_.B, tg_.SIZE, tg_.SIZE, 3).astype(np.float32)
    z = rng.randn(2, tg_.B, tg_.LAT).astype(np.float32)
    zs, inject = [z[0], z[1]], 3
    ppl_z = rng.randn(tg_.B // 2, tg_.LAT).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    cfg = tg_._cfg(tmp_path, compute_dtype="bfloat16")
    dp = jax.tree.map(jnp.asarray, d_tree)
    gan = tg_._trainer(tmp_path, g_params, d_tree, compute_dtype="bfloat16")
    assert gan.compute_dtype is bf
    gan.keep_first_grads = True
    draws = tg_._jax_draws(keys, [np.asarray(a) for a in zs], inject, ppl_z)
    g_names = ([n for n, _ in gan.netG.named_parameters()]
               + [f"noises.{i}" for i in range(len(gan.netG.noises))])
    d_names = [n for n, _ in gan.netD.named_parameters()]

    if kind in ("r1", "ppl"):
        _, r1_loss, _, ppl_loss = tg_._jax_step_losses(
            meta, jd.discriminator_meta(tg_.SIZE), cfg, jnp.asarray(real),
            [jnp.asarray(a) for a in zs], inject, ppl_z)
        if kind == "r1":
            loss, want = jax.jit(jax.value_and_grad(r1_loss))(dp, keys[1])
            ours = gan.r1_step(tg_._t(real), draws)
        else:
            loss, want = jax.jit(jax.value_and_grad(ppl_loss))(g_params, keys[3])
            ours = gan.ppl_step(draws)[0] * cfg.ppl_lambda * cfg.g_reg_every
        np.testing.assert_allclose(float(ours), float(loss), **tg_.LOSS_TOL)
        tg_._assert_grads_close(d_names if kind == "r1" else g_names,
                                gan.first_grads[kind], want, kind)
        assert all(g.dtype == torch.float32 for g in gan.first_grads[kind])
        return

    (d16, g16), (d32, g32) = _jax_bf16_steps(
        meta, jd.discriminator_meta(tg_.SIZE), cfg, jnp.asarray(real),
        [jnp.asarray(a) for a in zs], inject, tg_.P)
    jfns = {"d": (d16, d32), "g": (g16, g32)}[kind]
    args = (dp, g_params, keys[0]) if kind == "d" else (g_params, dp, keys[2])
    res = [jax.jit(jax.value_and_grad(f))(*args) for f in jfns]
    names = d_names if kind == "d" else g_names
    wants = []
    for loss, tree in res:
        flat = dict(convert_flatten(tree))
        wants.append((float(loss), _flat([flat[n] for n in names])))
    if kind == "d":
        ours, _, _, fake = gan.d_step(tg_._t(real), draws)
        assert fake.dtype == torch.float32
    else:
        ours = gan.g_step(draws)
    grads = gan.first_grads[kind]
    assert all(g.dtype == torch.float32 for g in grads)
    (l16, w16), (l32, w32) = wants
    got = _flat([g.numpy() for g in grads])
    assert abs(float(ours) - l16) <= BF16_FACTOR * abs(l16 - l32), (float(ours), l16, l32)
    err, own = np.linalg.norm(got - w16), np.linalg.norm(w16 - w32)
    assert err <= BF16_FACTOR * own, (err, own)
    norms = np.linalg.norm(got), np.linalg.norm(w16)
    assert abs(norms[0] - norms[1]) <= BF16_FACTOR * abs(np.linalg.norm(w16)
                                                          - np.linalg.norm(w32)) + own, norms


def convert_flatten(tree):
    from ganecdotes_torch.models.stylegan2 import convert

    return convert._flatten(jax.tree.map(np.asarray, tree))


def _bf16_run(tmp_path, tag, n_iters=4, **over):
    """tests/test_gan.py:457-511's run on the port: the tiny config with
    vanilla losses, ADA, no mixing and lazy regularisation every 3rd
    iteration, 4 iterations on one seeded batch."""
    import test_torch_gan as tg_

    cfg = tg_._cfg(tmp_path / tag, gan_mode="vanilla", augment=True, mixing_prob=0.0,
                   d_reg_every=3, g_reg_every=3, **over)
    gan = tg_.tt.BagGANHQ(cfg, seed=0, device="cpu")
    gan.setup_gan()
    real = np.random.RandomState(0).rand(tg_.B, tg_.SIZE, tg_.SIZE, 3).astype(np.float32) * 2 - 1
    losses = []
    for it in range(n_iters):
        gan.set_input(data_sample={"ct": real}, iter_no=it, epoch_no=0)
        gan.optimize_parameters()
        losses.append(dict(gan.get_current_losses()))
    return gan, losses


def test_bf16_training_tracks_float32(tmp_path):
    """tests/test_gan.py:457-511 on the port: every parameter and Adam
    moment stays float32 under bf16, iteration 0's losses within 0.05 of
    the float32 run's, every iteration finite, and 'float32' bit-equal to
    the default."""
    gan32, l32 = _bf16_run(tmp_path, "fp32")
    gan32e, l32e = _bf16_run(tmp_path, "fp32e", compute_dtype="float32")
    ganbf, lbf = _bf16_run(tmp_path, "bf16", compute_dtype="bfloat16")
    assert l32 == l32e
    for a, b in zip(gan32.g_tensors + gan32.d_tensors, gan32e.g_tensors + gan32e.d_tensors):
        assert torch.equal(a, b)
    for opt in (ganbf.optimizer_g, ganbf.optimizer_d):
        for t in opt.params + opt.m + opt.v:
            assert t.dtype == torch.float32
    for k in ("d", "g_gan"):
        assert abs(l32[0][k] - lbf[0][k]) < 0.05, (k, l32[0][k], lbf[0][k])
    assert all(np.isfinite(v) for rec in lbf for v in rec.values())
