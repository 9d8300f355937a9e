"""The port's data parallel (parallel/mesh.py and its users) on the CPU: two
gloo ranks in spawned processes (tests/torch_ranks.py, which imports no
JAX) held against one process on the global batch, and against the JAX
package on its virtual 8-device mesh (tests/conftest.py) or its
``make_swav_train_step(sample_batch=2)``.

Tolerances: a gather is exact; ADA's controller state equal (sums of
signs and counts); the SwAV step's loss 1e-5 relative and its params 1e-6
absolute plus 1e-5 relative (tests/test_torch_swav.py's); the GAN
iteration's losses 1e-5 relative and its gradients 1e-5 of each one's
norm (two halves summed against one sum), the weights after the step
1e-6; a request split over the ranks: image 1e-5, labels on 99.9% of
pixels (the synthesis of 4 against 8 is not batch-invariant to the last
bit).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ganecdotes_tpu.gan import ada as jada
from ganecdotes_tpu.parallel import mesh as jmesh
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_torch.gan import train as tt
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.parallel import mesh as pm
from ganecdotes_torch.selfsup import lars as tlars
from ganecdotes_torch.selfsup import swav as tswav
from test_torch_swav import (
    HLEN,
    NCLASSES,
    NPROTO,
    PARAM_TOL,
    PATCH,
    SIZE,
    _jax_draws,
    _jax_generator,
    _step_configs,
)

WORLD = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_process_mesh_and_refusals(monkeypatch):
    """Outside a process group: ``distributed_init`` is a no-op, the mesh
    is one rank, the collectives are the identity, and a mesh of more
    ranks than exist is refused, as JAX's ``make_mesh`` refuses more
    devices than it has (tests/test_parallel.py:23, :127)."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert pm.distributed_init() is False
    assert not torch.distributed.is_initialized()
    mesh = pm.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)
    with pytest.raises(ValueError, match="2 ranks requested"):
        pm.make_mesh(2)
    with pytest.raises(ValueError):
        jmesh.make_mesh(len(jax.devices()) + 1)
    x = torch.randn(4, 3)
    assert pm.all_gather(mesh, x) is x and torch.equal(pm.shard_batch(mesh, x), x)
    assert pm.average_gradients(mesh, [x])[0] is x
    with pytest.raises(ValueError, match="divide"):
        pm.batch_shardings(pm.Mesh(3, 0, torch.device("cpu")), 4)


def test_collectives_over_two_ranks_match_one_process_and_jax():
    """``data_parallel_infer`` against one process and JAX's over its
    8-device mesh (tests/test_parallel.py:28); ``shard_batch`` and
    ``replicate`` (:94); ``all_gather`` exact, with the first and second
    derivatives of a loss every rank takes over the gathered rows."""
    w = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    x = np.random.RandomState(1).randn(24, 16).astype(np.float32)
    outs = torch_ranks.run_ranks(torch_ranks.collectives, WORLD, w, x)
    want = np.tanh(x @ w)
    jwant = np.asarray(jmesh.data_parallel_infer(
        jmesh.make_mesh(8), lambda p, v: jnp.tanh(v @ p["w"]), {"w": w}, x))
    for r, out in enumerate(outs):
        assert out["refused"] and out["mesh"] == (WORLD, r)
        np.testing.assert_allclose(out["infer"], want, atol=1e-6)
        np.testing.assert_allclose(out["infer"], jwant, atol=1e-6)
        np.testing.assert_array_equal(out["shard"], x[12 * r:12 * (r + 1)])
        np.testing.assert_array_equal(out["rep"], np.zeros(3))  # rank 0's
        np.testing.assert_array_equal(out["gathered"], x)
        np.testing.assert_allclose(out["g"], WORLD * 2 * out["shard"] * out["c"],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["h"], WORLD * 2 * out["c"], rtol=1e-6)


def test_ada_update_over_ranks_matches_the_global_controller():
    """The sign statistics summed over the ranks equal the controller on
    the whole batch, and JAX's psum under shard_map (tests/test_parallel.py
    :42)."""
    preds = np.random.RandomState(2).randn(32).astype(np.float32)
    outs = torch_ranks.run_ranks(torch_ranks.ada, WORLD, preds, 8)
    st = jada.ada_init_state()
    for _ in range(8):
        st = jada.ada_update(st, jnp.asarray(preds), 0.6, 64, update_every=8)
    from ganecdotes_torch.gan.ada import ada_init_state, ada_update

    tst = ada_init_state()
    for _ in range(8):
        tst = ada_update(tst, torch.from_numpy(preds), 0.6, 64, 8)
    for out in outs:
        for k in ("p", "r_t"):
            assert float(out[k]) == float(tst[k])
            assert abs(float(out[k]) - float(st[k])) < 1e-6


def _swav_setup(key=12):
    params, meta, gen = _jax_generator()
    k_ssl, k_step = jax.random.split(jax.random.PRNGKey(key))
    ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
        k_ssl, HLEN, NCLASSES, NPROTO, "linear"))
    mean = (np.random.RandomState(13).randn(1, 512) * 0.3).astype(np.float32)
    mc, pa, sa, sk = _step_configs(0.05, 0.1, "uniform")
    setup = dict(gen_tree=jax.tree.map(np.asarray, params), ssl=ssl, mean=mean,
                 configs=(mc, pa, sa, sk), image_hw=(SIZE, SIZE))
    return setup, params, meta, gen, k_step


def test_swav_step_over_two_ranks_matches_the_sample_batch_and_jax():
    """One SwAV step, one sample a rank, against one process stepping on
    both samples and JAX's ``make_swav_train_step(sample_batch=2)`` with
    the same keys (tests/test_parallel.py:214's batched step)."""
    setup, params, meta, gen, k_step = _swav_setup()
    mc, pa, sa, sk = setup["configs"]
    keys = jax.random.split(k_step, WORLD)
    draws = [_jax_draws(k, meta, 2, sa["num_patches"], SIZE * SIZE, PATCH)
             for k in keys]
    outs = torch_ranks.run_ranks(torch_ranks.swav_step, WORLD, setup, draws)

    opt, step = tswav.make_swav_train_step(gen.meta, mc, pa, sa, sk,
                                           torch.from_numpy(setup["mean"]),
                                           (SIZE, SIZE))
    ssl = from_jax_params(setup["ssl"])
    one, _, one_loss = step(gen, ssl, opt.init(ssl), draws, 0)
    jopt, jstep = jswav.make_swav_train_step(
        meta, mc, pa, sa, sk, jnp.asarray(setup["mean"]), (SIZE, SIZE),
        sample_batch=WORLD)
    jssl = jax.tree.map(jnp.asarray, setup["ssl"])
    jp, _, jl = jstep(params, jssl, jopt.init(jssl), keys, 0)
    for out in outs:
        assert abs(out["loss"] - float(one_loss)) <= 1e-5 * abs(float(one_loss))
        assert abs(out["loss"] - float(jl)) <= 1e-5 * abs(float(jl))
        for a, b, c in zip(out["params"], tlars.tree_leaves(one), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, b.numpy(), **PARAM_TOL)
            np.testing.assert_allclose(a, np.asarray(c), **PARAM_TOL)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)  # the ranks stay replicated


def test_swav_batch_step_of_one_sample_is_the_single_step():
    """A batch of one sample (what each rank steps on) equals the step on
    that sample alone, bit for bit (tests/test_parallel.py:214)."""
    setup, _, meta, gen, k_step = _swav_setup()
    mc, pa, sa, sk = setup["configs"]
    draws = _jax_draws(k_step, meta, 2, sa["num_patches"], SIZE * SIZE, PATCH)
    opt, step = tswav.make_swav_train_step(gen.meta, mc, pa, sa, sk,
                                           torch.from_numpy(setup["mean"]),
                                           (SIZE, SIZE))
    ssl = from_jax_params(setup["ssl"])
    one, _, l1 = step(gen, ssl, opt.init(ssl), draws, 0)
    batch, _, lb = step(gen, ssl, opt.init(ssl), [draws], 0)
    assert torch.equal(l1, lb)
    for a, b in zip(tlars.tree_leaves(one), tlars.tree_leaves(batch)):
        assert torch.equal(a, b)


def test_swav_pretraining_data_parallel_over_two_ranks(tmp_path):
    """``SwAVClustering.pretrain`` with ``data_parallel`` (tests/
    test_parallel.py:170's case): each update takes the two samples both
    ranks drew, which one process replays through the step on both; the
    ranks end replicated, and only rank 0 writes ``swav_params.npz``."""
    setup, _, _, gen, _ = _swav_setup()
    mc, pa, sa, sk = setup["configs"]
    sa = dict(sa, num_epochs=2, num_samples=1, epoch_print_freq=1,
              sampling_method="random")
    mc_ns = dict(truncation=0.7, latent_dim=512, image_size=SIZE,
                 num_latents_for_mean=8)
    setup["clustering"] = (mc_ns, pa, sa, sk)
    outs = torch_ranks.run_ranks(torch_ranks.swav_pretrain, WORLD, setup,
                                 str(tmp_path))
    assert outs[0]["files"] == ["swav_params.npz"] and outs[1]["files"] == []
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)

    # one process: the same generator stream, both samples in each update
    pre = tswav.SwAVClustering(gen, types.SimpleNamespace(**mc_ns), pa, sa, sk,
                               device="cpu")
    pre.ssl_params = from_jax_params(tswav.init_swav_params(
        sa["hlen"], sa["nclasses"], sa["nprototypes"], sa["projn_nw"],
        generator=pre.generator))
    opt, step = tswav.make_swav_train_step(gen.meta, pre._model_config_dict(), pa,
                                           sa, sk, pre.mean_latent, (SIZE, SIZE))
    params, state = pre.ssl_params, opt.init(pre.ssl_params)
    for it in range(2):
        draws = [tswav.draw_step_inputs(pre.generator, gen.meta,
                                        pre._model_config_dict(), pa, sa,
                                        (SIZE, SIZE)) for _ in range(WORLD)]
        params, state, loss = step(gen, params, state, draws, it)
        assert abs(outs[0]["losses"][it] - float(loss)) <= 1e-5 * abs(float(loss))
    for a, b in zip(outs[0]["params"], tlars.tree_leaves(params)):
        np.testing.assert_allclose(a, b.numpy(), **PARAM_TOL)


def _gan_setup(tmp_path, batch=8, lr=0.0, **extra):
    """A 16^2 trainer, its weights and the global batch's draws. ``lr`` 0:
    each step kind's gradients are taken at the same weights in both runs
    (Adam's first step is about lr * sign(g), so a rounding-sized gradient
    near 0 moves a weight by a whole step). ``extra``: more config values
    (``compute_dtype``)."""
    cfg = dict(out_dir=str(tmp_path), checkpoint_dir=str(tmp_path / "ckpt"),
               is_train=True, image_size=16, latent_dim=32, num_channels=3,
               batch_size=batch, gan_mode="wgangp", use_ppl=True, r1_lambda=10,
               ppl_lambda=2, path_batch_shrink=2, ppl_decay=0.01, d_reg_every=4,
               g_reg_every=4, mixing_prob=0.9, chl_multiplier=1,
               res2chlmap={4: 16, 8: 12, 16: 8}, g_reg_ratio=4 / 5,
               d_reg_ratio=16 / 17, augment=True, augment_p=0, ada_target=0.6,
               ada_length=100, lr=lr, beta1=0.0, lr_policy="linear",
               lr_params=dict(epoch_count=1, n_epochs=2, n_epochs_decay=2),
               generator_params=dict(mlp_layers=2),
               losses_to_print=["g_gan", "d", "g_ppl"], start_epoch=1,
               continue_train=False, load_net=False)
    cfg.update(extra)
    gan = tt.BagGANHQ(types.SimpleNamespace(**cfg), seed=3, device="cpu")
    with torch.no_grad():  # noise reaches the image, D's bias is not zero
        for i, c in enumerate([gan.netG.conv1, *gan.netG.convs]):
            c.noise_weight.fill_(0.1 * (i + 1))
    draws = tt.draw_step_inputs(gan.generator, gan.config, gan.gen_meta, batch, 0,
                                0.6)
    real = (np.random.RandomState(0).rand(batch, 16, 16, 3) * 2 - 1).astype(np.float32)

    def arrays(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        if isinstance(v, (list, tuple)):
            return type(v)(arrays(u) for u in v)
        return v

    setup = dict(cfg=cfg, real=real, iter_no=0,
                 g={k: v.detach().numpy().copy() for k, v in gan.netG.state_dict().items()},
                 d={k: v.detach().numpy().copy() for k, v in gan.netD.state_dict().items()},
                 draws=[arrays(f) for f in draws])
    return gan, setup, draws


def test_gan_iteration_over_two_ranks_matches_one_process(tmp_path):
    """A BagGAN-HQ iteration (D with WGAN-GP and the remat, R1, G, PPL and
    ADA's controller; B = 8 as 4 + 4, so the minibatch standard
    deviation's strided groups span both ranks) against one process on the
    global batch and draws (tests/test_gan.py:821's case, here with every
    step kind due), at a learning rate of 0 so that every step kind's
    gradients are compared at the same weights; then, at the config's
    rate, the ranks' weights stay equal."""
    gan, setup, draws = _gan_setup(tmp_path)
    outs = torch_ranks.run_ranks(torch_ranks.gan_iteration, WORLD, setup)
    gan.keep_first_grads = True
    gan.set_input(data_sample={"ct": setup["real"]}, iter_no=0, draws=draws)
    gan.optimize_parameters()
    want = torch_ranks._gan_result(gan)
    assert set(want["grads"]) == {"d", "r1", "g", "ppl"}
    for out in outs:
        for k, v in want["losses"].items():
            assert abs(out["losses"][k] - v) <= 1e-5 * max(abs(v), 1e-3), k
        for k in ("p", "r_t", "buf"):
            np.testing.assert_allclose(out["ada"][k], want["ada"][k], rtol=1e-6)
        assert abs(out["mean_path_length"] - want["mean_path_length"]) <= 1e-6
        for kind, grads in want["grads"].items():
            for a, b in zip(out["grads"][kind], grads):
                scale = max(float(np.linalg.norm(b)), 1e-12)
                assert np.linalg.norm(a - b) <= 1e-5 * scale, kind
        for net in ("g", "d"):
            for k, v in want[net].items():
                np.testing.assert_allclose(out[net][k], v, atol=1e-6, rtol=1e-5)
    _, setup, _ = _gan_setup(tmp_path / "lr", lr=0.002)
    outs = torch_ranks.run_ranks(torch_ranks.gan_iteration, WORLD, setup)
    for net in ("g", "d"):  # the ranks stay replicated
        assert any(not np.array_equal(outs[0][net][k], setup[net][k])
                   for k in setup[net])
        for k in setup[net]:
            np.testing.assert_array_equal(outs[0][net][k], outs[1][net][k])
    assert outs[0]["ckpt"] == ["latest_net_D.npz", "latest_net_G.npz"]
    assert outs[1]["ckpt"] == []


def test_bf16_gan_iteration_over_two_ranks_matches_one_process(tmp_path):
    """The iteration above with ``compute_dtype='bfloat16'`` (B = 8 as 4 +
    4, lr 0): the D and G steps in bf16 on each rank, the minibatch
    standard deviation gathered over the ranks in the activation's bf16
    (gloo sums bf16; the gather adds zeros, so it is exact), against one
    process on the global batch. The ranks' bf16 convs on 4 samples and the
    one process's on 8 round apart, so the gate is bf16's own: each loss
    and each step kind's gradient within twice the one process's bf16
    against float32 difference (R1 and PPL, float32 in both, within the
    float32 test's 1e-5)."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        gan, setup, draws = _gan_setup(tmp_path / dtype, compute_dtype=dtype)
        gan.keep_first_grads = True
        gan.set_input(data_sample={"ct": setup["real"]}, iter_no=0, draws=draws)
        gan.optimize_parameters()
        runs[dtype] = torch_ranks._gan_result(gan), setup
    (want, setup), (want32, _) = runs["bfloat16"], runs["float32"]
    outs = torch_ranks.run_ranks(torch_ranks.gan_iteration, WORLD, setup)

    def flat(grads):
        return np.concatenate([g.ravel() for g in grads])

    for out in outs:
        for k, v in want["losses"].items():
            if k in ("loss_d_r1", "loss_g_ppl"):
                assert abs(out["losses"][k] - v) <= 1e-5 * max(abs(v), 1e-3), k
            else:
                assert abs(out["losses"][k] - v) <= 2 * abs(v - want32["losses"][k]), k
        for kind, grads in want["grads"].items():
            a, b = flat(out["grads"][kind]), flat(grads)
            if kind in ("r1", "ppl"):
                assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), kind
            else:
                own = np.linalg.norm(b - flat(want32["grads"][kind]))
                assert np.linalg.norm(a - b) <= 2 * own, kind


def test_gan_steps_over_two_ranks_match_jax_on_its_mesh(tmp_path):
    """Each BagGAN-HQ step kind over two ranks (B = 8 as 4 + 4, so the
    minibatch standard deviation's strided groups span both ranks) against
    the JAX package directly: its step losses (tests/test_torch_gan.py's
    ``_jax_step_losses``, train.py:392-581) jitted with the batch sharded
    over a 2-device mesh, as its data-parallel trainer jits its steps
    (train.py:644-680), on the same weights and the draws rebuilt from the
    same keys; tests/test_torch_gan.py's tolerances."""
    import test_torch_gan as tg

    from ganecdotes_tpu.models.stylegan2 import discriminator as jd
    from ganecdotes_tpu.models.stylegan2 import generator as jg

    batch, size = 8, tg.SIZE
    g_params, meta = tg._jax_generator()
    d_tree = tg.disc_tree(seed=4, widths=tg.WIDTHS)
    rng = np.random.RandomState(5)
    real = rng.randn(batch, size, size, 3).astype(np.float32)
    z = rng.randn(2, batch, tg.LAT).astype(np.float32)
    inject = 3
    ppl_z = rng.randn(batch // 2, tg.LAT).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    cfg = tg._cfg(tmp_path, batch_size=batch, lr=0.0)

    @jax.jit
    def aug(key):  # augment's (G, C) for the global batch (ada.py:317, :282)
        k1, k2 = jax.random.split(key)
        return (jnp.linalg.inv(jada.sample_affine(k1, tg.P, batch, size, size)),
                jada.sample_color(k2, tg.P, batch))

    noise = jax.jit(lambda k: jg.make_noise(jg.generator_meta(size), k, batch))
    kd, kr, kg, kp = keys
    kz, kdd = jax.random.split(kd)
    k1, k2, k3 = jax.random.split(kdd, 3)
    kzg, ka = jax.random.split(kg)
    _, kn = jax.random.split(kp)
    draws = [list(z), inject, list(noise(kz)), aug(k1), aug(k2),
             jax.random.uniform(k3, (batch, 1, 1, 1)), aug(kr), list(noise(kzg)),
             aug(ka), ppl_z, jax.random.normal(kn, (batch // 2, size, size, 3)) / size]
    draws = jax.tree.map(lambda a: np.array(a, np.float32), draws)
    draws[1] = inject
    setup = dict(cfg=vars(cfg), real=real, draws=draws, d_tree=d_tree,
                 g_tree=jax.tree.map(np.asarray, g_params))
    outs = torch_ranks.run_ranks(torch_ranks.gan_steps, WORLD, setup)

    mesh = jmesh.make_mesh(WORLD)
    repl, bsh = jmesh.batch_shardings(mesh)
    d_meta = jd.discriminator_meta(size)

    def step_loss(kind):
        i = ("d", "r1", "g", "ppl").index(kind)

        def loss(params, others, key, real_, z0, z1, pz):
            fns = tg._jax_step_losses(meta, d_meta, cfg, real_, [z0, z1], inject, pz)
            return fns[i](params, *others, key)

        return jax.jit(jax.value_and_grad(loss),
                       in_shardings=(repl, repl, repl, bsh, bsh, bsh, bsh))

    dp = jax.tree.map(jnp.asarray, d_tree)
    batched = [jnp.asarray(a) for a in (real, z[0], z[1], ppl_z)]
    want = {"d": step_loss("d")(dp, (g_params,), kd, *batched),
            "r1": step_loss("r1")(dp, (), kr, *batched),
            "g": step_loss("g")(g_params, (dp,), kg, *batched),
            "ppl": step_loss("ppl")(g_params, (), kp, *batched)}
    for out in outs:
        for kind, (loss, grads) in want.items():
            np.testing.assert_allclose(out["losses"][kind], float(loss), **tg.LOSS_TOL)
            names = out["names"]["d" if kind in ("d", "r1") else "g"]
            tg._assert_grads_close(names, out["grads"][kind], grads, kind)


def test_minibatch_stddev_of_the_global_batch():
    """The statistic over ranks equals one process's: the same function on
    the global batch, each rank's rows kept. The groups are strided (rows
    j, j + 2, j + 4, j + 6 of 8), so each spans both ranks' 4 rows, and a
    rank's rows alone give another statistic."""
    from ganecdotes_torch.models.stylegan2.discriminator import minibatch_stddev

    x = torch.randn(8, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    whole = minibatch_stddev(x, 4)
    for rank in range(2):
        mesh = pm.Mesh(2, rank, torch.device("cpu"))
        mine = x[4 * rank:4 * rank + 4]
        with pytest.MonkeyPatch.context() as mp:  # gather as the ranks would
            mp.setattr("ganecdotes_torch.models.stylegan2.discriminator.all_gather",
                       lambda m, t: x)
            got = minibatch_stddev(mine, 4, mesh=mesh)
        assert torch.equal(got, whole[4 * rank:4 * rank + 4])
        assert not torch.equal(minibatch_stddev(mine, 4), got)


def test_serving_request_over_two_ranks(tmp_path):
    """A request of 8 as 4 + 4 through ``data_parallel_infer`` over the
    folded server, against the request of 8 in one process."""
    from test_torch_serving import _configs

    mc, sc = _configs(32)
    setup = dict(configs=(vars(mc), vars(sc)), seed=0)
    latents = np.random.RandomState(4).randn(8, 512).astype(np.float32)
    outs = torch_ranks.run_ranks(torch_ranks.serve, WORLD, setup, latents)
    from ganecdotes_torch.pipeline.serving import OneShotServer

    img, labels, _ = OneShotServer(mc, sc, device="cpu", seed=0).serve(
        torch.from_numpy(latents), input_is_latent=True)
    for out in outs:
        np.testing.assert_allclose(out[0], img.numpy(), atol=1e-5)
        assert (out[1] == labels.numpy()).mean() >= 0.999


def test_pipeline_test_requests_over_two_ranks(tmp_path):
    """The evaluate path with its test requests split over two ranks and
    gathered: the labels of one process's run; only rank 0 scores."""
    import shutil

    from test_torch_pipeline import _write_configs, _samples
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)))
    one = str(tmp_path / "one")
    pipe = OneShotPipeline(out_dir=one, model="ffhq-256", segmentor="hfc_with_swav",
                           num_test_samples=3, custom=cfg, device="cpu", seed=5)
    pipe.run_pipeline()  # pretrains SwAV into swav_params.npz
    ranks_dir = str(tmp_path / "ranks")
    os.makedirs(ranks_dir)
    shutil.copy2(os.path.join(one, "swav_params.npz"), ranks_dir)
    pipe = OneShotPipeline(out_dir=one, model="ffhq-256", segmentor="hfc_with_swav",
                           num_test_samples=3, custom=cfg, device="cpu", seed=5)
    pipe.seg_config.train_hfc = False
    pipe.seg_config.hfc_prep_args["train"] = False
    pipe.run_pipeline()
    outs = torch_ranks.run_ranks(torch_ranks.pipeline, WORLD, ranks_dir, cfg, 5)
    assert [o["scored"] for o in outs] == [True, False]
    for out in outs:
        assert out["mesh"] == WORLD
        assert (out["pred"] == pipe.pred_labels).mean() >= 0.999
    assert os.path.exists(os.path.join(ranks_dir, "tests", "label_predictions.npy"))
