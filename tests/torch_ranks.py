"""Run a function in ranks of spawned processes joined over gloo, for the
port's data-parallel tests; and the functions the ranks run.

The module imports torch and the port, never JAX: a rank is a fresh
process, and a JAX import there would cost seconds a rank. ``run_ranks``
picks a free localhost port, starts the ranks with the spawn method and
waits for all of them within its own timeout, so a rendezvous that hangs
fails one test and cannot stall the run; a rank's error is raised with
its traceback. Arguments and results cross the process boundary as numpy
arrays and plain Python values.
"""

import os
import queue
import socket
import time
import traceback
import types

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, args, results):
    try:
        for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)
        torch.set_num_threads(1)
        from ganecdotes_torch.parallel.mesh import distributed_init

        distributed_init(f"tcp://localhost:{port}", world, rank, backend="gloo")
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # the parent raises it, with the rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, *args, timeout=300):
    """[fn(rank, world, *args) for each rank], each in its own process in
    one gloo group of ``world`` ranks."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks did not "
                                   f"finish within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the functions the ranks run
# ---------------------------------------------------------------------------


def collectives(rank, world, w, x):
    """``make_mesh``'s refusal, ``data_parallel_infer`` (rank 0's params:
    the others pass zeros), ``shard_batch``/``replicate``, and
    ``all_gather``'s first and second derivatives."""
    from ganecdotes_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    try:
        pm.make_mesh(world + 1)
        refused = False
    except ValueError:
        refused = True
    params = {"w": torch.from_numpy(w) * (1 if rank == 0 else 0)}
    infer = pm.data_parallel_infer(mesh, lambda p, v: torch.tanh(v @ p["w"]),
                                   params, torch.from_numpy(x))
    xs = pm.shard_batch(mesh, torch.from_numpy(x))
    rep = pm.replicate(mesh, {"a": [torch.full((3,), float(rank))]})["a"][0]
    # y = all rows; L = sum(y^2 * c) on every rank: dL/dx_r = world * 2 x c_r
    local = xs.clone().requires_grad_(True)
    c = torch.arange(x.size, dtype=torch.float32).reshape(x.shape) / x.size
    y = pm.all_gather(mesh, local)
    (g,) = torch.autograd.grad((y.square() * c).sum(), local, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), local)
    return dict(refused=refused, infer=_np(infer), shard=_np(xs), rep=_np(rep),
                gathered=_np(y), g=_np(g), h=_np(h), c=_np(pm.shard_batch(mesh, c)),
                mesh=(mesh.size, mesh.rank))


def ada(rank, world, preds, steps):
    """``ada_update`` over the rank's slice with the statistics summed."""
    from ganecdotes_torch.gan.ada import ada_init_state, ada_update
    from ganecdotes_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    st = ada_init_state()
    mine = pm.shard_batch(mesh, torch.from_numpy(preds))
    for _ in range(steps):
        st = ada_update(st, mine, 0.6, 64, 8, mesh)
    return {k: _np(v) for k, v in st.items()}


def _swav_setup(setup):
    from ganecdotes_torch.models.stylegan2.convert import (
        from_jax_generator_params,
        from_jax_params,
    )

    gen = from_jax_generator_params(setup["gen_tree"])
    return gen, from_jax_params(setup["ssl"]), torch.from_numpy(setup["mean"])


def swav_step(rank, world, setup, draws):
    """One SwAV step over a mesh, the rank's sample ``draws[rank]``."""
    from ganecdotes_torch.parallel import mesh as pm
    from ganecdotes_torch.selfsup import lars, swav

    gen, ssl, mean = _swav_setup(setup)
    mesh = pm.make_mesh()
    opt, step = swav.make_swav_train_step(gen.meta, *setup["configs"], mean,
                                          setup["image_hw"], mesh=mesh)
    params, state, loss = step(gen, ssl, opt.init(ssl), [draws[rank]], 0)
    return dict(loss=float(loss), params=[_np(t) for t in lars.tree_leaves(params)])


def swav_pretrain(rank, world, setup, out_dir):
    """``SwAVClustering.pretrain`` with ``data_parallel``: its params and
    the files each rank wrote."""
    from ganecdotes_torch.selfsup import lars, swav

    gen, _, _ = _swav_setup(setup)
    mc, pa, sa, sk = setup["clustering"]
    d = os.path.join(out_dir, f"rank{rank}")
    pre = swav.SwAVClustering(gen, types.SimpleNamespace(**mc), pa,
                              dict(sa, data_parallel=True), sk, out_dir=d,
                              device="cpu")
    pre.record_loss_history = True
    pre.pretrain()
    return dict(params=[_np(t) for t in lars.tree_leaves(pre.ssl_params)],
                losses=list(pre.loss_history),
                files=sorted(f for f in os.listdir(d) if f.endswith(".npz")))


def gan_iteration(rank, world, setup):
    """One BagGAN-HQ iteration with ``data_parallel`` on the global batch
    and draws: losses, ADA's state, the first gradients and the weights."""
    from ganecdotes_torch.gan import train

    cfg = types.SimpleNamespace(**dict(setup["cfg"], data_parallel=True,
                                       checkpoint_dir=os.path.join(
                                           setup["cfg"]["checkpoint_dir"], str(rank))))
    gan = train.BagGANHQ(cfg, device="cpu")
    assert gan.mesh is not None and gan.mesh.size == world
    gan.netG.load_state_dict({k: torch.from_numpy(v) for k, v in setup["g"].items()})
    gan.netD.load_state_dict({k: torch.from_numpy(v) for k, v in setup["d"].items()})
    gan.keep_first_grads = True
    draws = train.BagGANDraws(*[_tensors(f) for f in setup["draws"]])
    gan.set_input(data_sample={"ct": setup["real"]}, iter_no=setup["iter_no"],
                  draws=draws)
    gan.optimize_parameters()
    gan.save_networks("latest")
    return _gan_result(gan)


def gan_steps(rank, world, setup):
    """Each BagGAN-HQ step kind once with ``data_parallel``, on the JAX
    nets' weights (the discriminator narrowed to its tree) and the global
    batch's draws, at a learning rate of 0 so that every kind runs at those
    weights: each kind's loss, its gradients averaged over the ranks, and
    the parameter names in their order."""
    from ganecdotes_torch.gan import train
    from ganecdotes_torch.models.stylegan2 import convert

    cfg = types.SimpleNamespace(**dict(setup["cfg"], data_parallel=True,
                                       checkpoint_dir=os.path.join(
                                           setup["cfg"]["checkpoint_dir"], str(rank))))
    gan = train.BagGANHQ(cfg, device="cpu")
    assert gan.mesh is not None and gan.mesh.size == world
    gan.netG.load_state_dict(convert.tree_to_state(setup["g_tree"]))
    gan.netD = convert.from_jax_discriminator_params(setup["d_tree"])
    gan.d_tensors = list(gan.netD.parameters())
    gan.optimizer_d = train.Adam(gan.d_tensors, 0.0)
    gan.keep_first_grads = True
    gan.set_input(data_sample={"ct": setup["real"]}, iter_no=0,
                  draws=train.BagGANDraws(*[_tensors(f) for f in setup["draws"]]))
    real, d = gan.ref_image, gan.draws
    losses = {"d": gan.d_step(real, d)[0], "r1": gan.r1_step(real, d),
              "g": gan.g_step(d),
              "ppl": gan.ppl_step(d)[0] * cfg.ppl_lambda * cfg.g_reg_every}
    g_names = [n for n, _ in gan.netG.named_parameters()]
    g_names += [f"noises.{i}" for i in range(len(gan.netG.noises))]
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={k: [_np(g) for g in v] for k, v in gan.first_grads.items()},
                names={"d": [n for n, _ in gan.netD.named_parameters()], "g": g_names})


def _tensors(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_tensors(u) for u in v)
    return v


def _gan_result(gan):
    names = ("loss_d", "loss_d_out", "loss_d_ref", "loss_d_r1", "loss_g_gan",
             "loss_g_ppl")
    return dict(losses={n: float(getattr(gan, n)) for n in names if hasattr(gan, n)},
                ada={k: _np(v) for k, v in gan.ada_state.items()},
                mean_path_length=float(gan.mean_path_length),
                grads={k: [_np(g) for g in v] for k, v in gan.first_grads.items()},
                g={k: _np(v) for k, v in gan.netG.state_dict().items()},
                d={k: _np(v) for k, v in gan.netD.state_dict().items()},
                ckpt=sorted(os.listdir(gan.checkpoint_dir)))


def serve(rank, world, setup, latents):
    """A request of the global batch through ``data_parallel_infer`` over
    the OneShotServer's folded form."""
    from ganecdotes_torch.parallel import mesh as pm
    from ganecdotes_torch.pipeline.serving import OneShotServer

    mc, sc = setup["configs"]
    server = OneShotServer(types.SimpleNamespace(**mc), types.SimpleNamespace(**sc),
                           device="cpu", seed=setup["seed"])
    out = pm.data_parallel_infer(
        pm.make_mesh(), lambda _, v: server.serve(v, input_is_latent=True)[:2],
        None, torch.from_numpy(latents))
    return [_np(t) for t in out]


def pipeline(rank, world, out_dir, cfg, seed):
    """The tiny evaluate pipeline with its test requests split over the
    ranks: the predicted labels, and which files the rank wrote."""
    from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

    pipe = OneShotPipeline(out_dir=out_dir, model="ffhq-256",
                           segmentor="hfc_with_swav", num_test_samples=3,
                           custom=cfg, device="cpu", seed=seed)
    pipe.seg_config.train_hfc = False
    pipe.seg_config.hfc_prep_args["train"] = False
    assert pipe.mesh is not None and pipe.mesh.rank == rank
    pipe.run_pipeline()
    return dict(pred=pipe.pred_labels, mesh=pipe.mesh.size,
                scored=hasattr(pipe, "test_results"))


def save_tree(rank, world, path, arrays):
    """``save_pytree_orbax`` of the replicated tree {name: array} (bf16
    where the name starts with 'bf16') from every rank of the group."""
    from ganecdotes_torch.utils.serialization import save_pytree_orbax

    tree = {k: torch.from_numpy(v).to(torch.bfloat16) if k.startswith("bf16")
            else torch.from_numpy(v) for k, v in arrays.items()}
    save_pytree_orbax(path, {"weights": tree, "step": (torch.tensor(7), [tree["w"]])})
    return rank
