"""Data parallel over ranks (port of ganecdotes_tpu/parallel/mesh.py).

The JAX package shards a jitted program's batch over a device mesh and lets
XLA insert the collectives. Here each card runs one process (``torchrun
--nproc_per_node=N``), the processes form a ``torch.distributed`` group, and
the code calls the collectives itself:

* a ``Mesh`` is the group as one rank sees it: its size, its rank, its
  device;
* ``shard_batch`` is the rank's slice of a global batch, ``replicate``
  broadcasts rank 0's tensors, ``gather_batch`` puts the slices back
  together on every rank, and ``data_parallel`` runs a request over the
  ranks with all three (the pipeline's test requests go through it);
* ``all_reduce_sum`` and ``all_gather`` are differentiable to any order
  (each one's backward is again an all-reduce), for statistics over the
  global batch inside a step that is differentiated twice (the
  discriminator's minibatch standard deviation under R1 and WGAN-GP);
* ``average_gradients`` averages a step's gradients over the ranks in one
  all-reduce.

Every collective is an all-reduce or a broadcast, the two that every
backend runs on CUDA tensors (gloo's CUDA support has no all-gather): a
gather is an all-reduce of the slices placed in zeros, which is exact. The
backend is NCCL on CUDA and gloo on the CPU unless the caller names one.
"""

import functools
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One rank's view of the data-parallel group (the default process
    group): ``size`` ranks, this one's ``rank``, its ``device``."""

    size: int
    rank: int
    device: torch.device


def distributed_init(init_method=None, world_size=None, rank=None, backend=None):
    """Join the process group -> True, or False in a single process.

    Without arguments it reads ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); a process
    with no such environment and no ``init_method`` is a single-process
    run and nothing happens. ``backend`` defaults to NCCL where CUDA is
    available and gloo otherwise; with NCCL the process takes the card
    ``LOCAL_RANK``. Safe to call again once joined."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        if world_size <= 1:
            return False
        init_method = "env://"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return True


def make_mesh(n_devices=None, device=None):
    """The mesh of every rank of the process group (one rank outside one)
    -> ``Mesh``. ``n_devices``, where given, must be the number of ranks:
    more raise, rather than report a run over ranks that never ran, as
    JAX's ``make_mesh`` refuses more devices than it has. ``device``
    defaults to the card the process took (``distributed_init``), else the
    CPU."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None and n_devices > size:
        raise ValueError(
            f"make_mesh: {n_devices} ranks requested but only {size} exist; "
            "a smaller mesh would report a data-parallel run that never ran")
    if n_devices is not None and n_devices < size:
        raise ValueError(f"make_mesh: a mesh spans all {size} ranks of the "
                         f"process group, not {n_devices}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(size, rank, torch.device(device))


def batch_shardings(mesh, batch):
    """(the replicated slice, the rank's slice) of a global batch of
    ``batch`` rows: every rank's params take the first, its data the
    second. The batch must divide over the ranks."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not divide over {mesh.size} ranks")
    b = batch // mesh.size
    return slice(None), slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh, x):
    """The rank's rows of a global batch ``x`` (leading axis)."""
    return x[batch_shardings(mesh, x.shape[0])[1]]


def replicate(mesh, tree):
    """Rank 0's values of every tensor in ``tree`` (dicts, lists, tuples),
    broadcast to every rank; returns the tree of broadcast copies."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if not isinstance(tree, torch.Tensor) or mesh.size == 1:
        return tree
    out = tree.detach().clone().contiguous()
    dist.broadcast(out, src=0)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank. Its adjoint is
    itself: each rank's x reaches every rank's y."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone().contiguous()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous())


def all_reduce_sum(mesh, x):
    """The sum of ``x`` over the ranks, differentiable to any order."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x)


def all_gather(mesh, x):
    """The ranks' ``x`` (equal shapes) concatenated on the leading axis in
    rank order, on every rank: each rank's rows placed in zeros, summed
    over the ranks. Exact, and differentiable to any order (a rank's rows
    get the sum of every rank's gradient for them)."""
    if mesh is None or mesh.size == 1:
        return x
    parts = [torch.zeros_like(x)] * mesh.size
    parts[mesh.rank] = x
    return all_reduce_sum(mesh, torch.cat(parts))


def gather_batch(mesh, x):
    """``all_gather`` without a gradient, for outputs (any dtype the
    backend sums)."""
    with torch.no_grad():
        return all_gather(mesh, x)


def mean_over_ranks(mesh, x):
    """The mean of a per-rank value (a loss) over the ranks, no gradient."""
    if mesh is None or mesh.size == 1:
        return x
    with torch.no_grad():
        return all_reduce_sum(mesh, x) / mesh.size


def average_gradients(mesh, grads):
    """Each gradient's mean over the ranks, in one all-reduce of their
    concatenation."""
    if mesh is None or mesh.size == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.size
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


def data_parallel(mesh, make_infer, params_tree):
    """``make_infer(params)``'s request, run over the ranks: rank 0's
    ``params_tree`` is broadcast once and handed to ``make_infer``, and the
    function returned takes a global batch of latents, computes the rank's
    slice and gathers each output (a tensor, or a tuple of tensors with the
    batch leading, None staying None) on every rank."""
    infer = make_infer(replicate(mesh, params_tree))

    def run(latents):
        out = infer(shard_batch(mesh, latents))
        if isinstance(out, (tuple, list)):
            return type(out)(None if o is None else gather_batch(mesh, o) for o in out)
        return gather_batch(mesh, out)

    return run


def data_parallel_infer(mesh, infer_fn, params_tree, latents):
    """``infer_fn(params, latents)`` over the global batch ``latents``, each
    rank computing its slice with rank 0's params; the outputs gathered on
    every rank (``data_parallel``)."""
    return data_parallel(mesh, lambda params: functools.partial(infer_fn, params),
                         params_tree)(latents)
