"""Train a BagGAN-HQ model (StyleGAN2 + ADA) on a directory of .npy images,
on the port (the flags of the top-level ``train_baggan.py``, plus
``--device``).

    python -m ganecdotes_torch.cli.train_baggan \
        --config ganecdotes_torch/configs/models/baggan/config_pidray_unlabeled.py \
        --data_dir /path/to/npy --epochs 10

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device`` it raises. The config is a BagGAN run config file (the
port's copies are under ``configs/models/baggan/``). ``--out_dir``
re-derives its ``checkpoint_dir`` (``<out_dir>/checkpoints``), ``snap_dir``,
``losses_file`` and log path. With ``--data_dir`` the batches come from the
native ``.npy`` loader (``runtime.NativeDataLoader``; every ``*.npy`` under the
directory, uint8 or float32 (H, W, C)) with one worker thread, so that a
run's batches come in one order for its files (the JAX CLI's four threads
race for the queue; one thread decodes a batch in a small fraction of an
iteration), each copied to the device; without it, from
``np.random.RandomState(0).rand(...) * 2 - 1`` noise, the JAX CLI's
batches. Each epoch logs its losses and ADA's p; every
``--save_every`` epochs it writes ``latest`` and ``<epoch>`` checkpoints
(``%s_net_%s.npz``, readable by both packages; the pidray evaluate path
loads ``latest_net_G.npz`` from the run config's ``checkpoint_dir``), and
it steps the learning-rate policy at each epoch's end. A resume is the
config's ``continue_train = True`` with ``load_epoch``.

Under ``torchrun --nproc_per_node=N`` (one process per card, N dividing the
batch) it trains data-parallel (the config's ``data_parallel``, on unless
the config sets it, as the JAX CLI turns it on above one device): every
rank loads the global batch and keeps its slice, and rank 0 writes the
checkpoints.

``--chunk k`` above 1 hands each k iterations to
``BagGANHQ.optimize_parameters_chunk`` in one call (a last, shorter call
takes the rest of the epoch), as the JAX CLI does: its runs of plain (D,
G) iterations execute back to back with no host sync, and the run follows
the same trajectory as ``--chunk 1``. The run config's ``compute_dtype =
'bfloat16'`` trains the D and G steps in bf16 (``gan.train``).
"""

import argparse
import glob
import os
import time

import numpy as np
import torch

from ganecdotes_torch.gan.train import BagGANHQ
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.parallel.mesh import distributed_init
from ganecdotes_torch.runtime import NativeDataLoader
from ganecdotes_torch.utils.util import load_config


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train a BagGAN-HQ model on a directory of .npy images.")
    parser.add_argument("--config", required=True,
                        help="BagGAN run config file (see configs/models/baggan/)")
    parser.add_argument("--data_dir", default=None,
                        help=".npy image directory; synthetic noise when absent")
    parser.add_argument("--out_dir", default=None, help="override config.out_dir")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--iters_per_epoch", type=int, default=None)
    parser.add_argument("--save_every", type=int, default=1,
                        help="checkpoint every N epochs")
    parser.add_argument("--chunk", type=int, default=1,
                        help="GAN iterations per optimizer call; above 1 runs "
                             "the plain (D, G) iterations between lazy "
                             "regularisations back to back with no host sync "
                             "(the same trajectory as 1)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs "
                             "the plain PyTorch path)")
    return parser


def load_run_config(path, out_dir=None):
    """The run config module; ``out_dir`` re-derives every path the config
    computed from its own out_dir when it was loaded."""
    cfg = load_config(path, "baggan_config")
    if out_dir:
        cfg.out_dir = out_dir
        cfg.checkpoint_dir = os.path.join(out_dir, "checkpoints")
        cfg.training_log_path = os.path.join(
            out_dir, time.strftime("train_%m%d%Y_%H%M%S.log"))
        cfg.snap_dir = os.path.join(out_dir, "training_snaps")
        cfg.losses_file = os.path.join(out_dir, "training_losses.npz")
        os.makedirs(out_dir, exist_ok=True)
    return cfg


def run(args, ops=KERNELS):
    """The CLI's run for parsed ``args`` with op set ``ops`` (``KERNELS`` or
    ``PLAIN``). Returns (the trainer, a record: the data source and the
    loader's counts, per-epoch losses and ADA p, per optimizer call its
    iterations, losses and host ms with the card synced, per batch its sum
    and the ms it took to arrive)."""
    chunk = max(1, args.chunk)
    cfg = load_run_config(args.config, args.out_dir)
    n_epochs = args.epochs or getattr(cfg, "n_epochs", 10)
    size, chans = cfg.image_size, getattr(cfg, "num_channels", 3)
    if distributed_init():
        ranks = torch.distributed.get_world_size()
        if cfg.batch_size % ranks:
            raise SystemExit(f"batch_size {cfg.batch_size} does not divide over "
                             f"{ranks} ranks")
        if not hasattr(cfg, "data_parallel"):
            cfg.data_parallel = True
    gan = BagGANHQ(cfg, device=args.device, ops=ops)
    gan.setup_gan()
    gan.print_networks()
    sync = (torch.cuda.synchronize if gan.device.type == "cuda" else lambda: None)

    loader = None
    if args.data_dir:
        paths = sorted(glob.glob(os.path.join(args.data_dir, "**", "*.npy"),
                                 recursive=True))
        if not paths:
            raise SystemExit(f"no .npy files under {args.data_dir}")
        loader = NativeDataLoader(paths, cfg.batch_size, size, size, chans, n_threads=1)
        source = type(loader).__name__
        iters = args.iters_per_epoch or max(1, len(paths) // cfg.batch_size)
        next_batch = loader.next
        gan.logger.info(f"data: {len(paths)} files, loader={source}, {iters} iters/epoch")
    else:
        source = "noise"
        iters = args.iters_per_epoch or 10
        rng = np.random.RandomState(0)
        gan.logger.info("no --data_dir: training against noise (smoke mode)")

        def next_batch():
            return rng.rand(cfg.batch_size, size, size, chans).astype(np.float32) * 2 - 1

    rec = {"source": source, "iters_per_epoch": iters, "chunk": chunk, "epochs": [],
           "losses": [], "call_iterations": [], "iteration_ms": [],
           "batch_wait_ms": [], "batch_sums": []}
    try:
        it = 0
        for epoch in range(gan.epoch, gan.epoch + n_epochs):
            t0 = time.time()
            done = 0
            while done < iters:
                k = min(chunk, iters - done)
                sync()
                ti = time.perf_counter()
                batches = []
                for _ in range(k):
                    tb = time.perf_counter()
                    batches.append(next_batch())
                    rec["batch_wait_ms"].append((time.perf_counter() - tb) * 1e3)
                if k == 1:
                    gan.set_input(data_sample={"ct": batches[0]}, iter_no=it,
                                  epoch_no=epoch)
                    gan.optimize_parameters()
                else:
                    gan.iter_no, gan.epoch_no = it, epoch
                    gan.optimize_parameters_chunk([{"ct": b} for b in batches])
                sync()
                rec["iteration_ms"].append((time.perf_counter() - ti) * 1e3)
                rec["call_iterations"].append(k)
                rec["losses"].append(gan.get_current_losses())
                rec["batch_sums"] += [float(b.sum(dtype=np.float64)) for b in batches]
                it += k
                done += k
            losses = gan.get_current_losses()
            rec["epochs"].append({"epoch": epoch, "losses": losses,
                                  "ada_p": gan.ada_aug_p, "s": time.time() - t0})
            loss_str = " ".join(f"{k}={v:.4f}" for k, v in losses.items())
            gan.logger.info(f"epoch {epoch} | {loss_str} | ada_p={gan.ada_aug_p:.3f} "
                            f"| {time.time() - t0:.1f}s")
            if loader is not None and loader.decode_errors:
                total = loader.batches_produced * cfg.batch_size
                gan.logger.error(
                    f"data loader: {loader.decode_errors}/{total} samples failed to "
                    f"decode (wrong shape/dtype? expected ({size},{size},{chans})) "
                    "- they train as zeros")
                if loader.decode_errors >= total:
                    raise SystemExit("every sample failed to decode; refusing to "
                                     "train on all-zero batches")
            if epoch % args.save_every == 0:
                gan.save_networks("latest")
                gan.save_networks(str(epoch))
            gan.update_learning_rate()
    finally:
        if loader is not None:
            loader.close()
            rec["decode_errors"] = loader.decode_errors
            rec["batches_produced"] = loader.batches_produced
    gan.save_networks("latest")
    gan.logger.info("training complete")
    return gan, rec


def main(argv=None):
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
