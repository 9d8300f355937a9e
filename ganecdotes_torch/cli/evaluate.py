"""Evaluate a saved self-supervised clustering model for one-shot
segmentation on the port (the flags of the top-level ``evaluate.py``, plus
``--device`` and every model key whose config file ships).

    python -m ganecdotes_torch.cli.evaluate --model ffhq-256 \
        --method hfc_with_swav --out_dir results/evaluate_default/

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device`` it raises. The generator is the model config's
reference checkpoint (``model_path``, a rosinality ``g_ema`` ``.pt``; for the
PIDRay models the newest ``*_net_G.npz`` or ``*_net_G.pth`` in the BagGAN
run config's ``checkpoint_dir``), random from the seed where none is there.
The SwAV params are loaded from ``<out_dir>/swav_params.npz``, else from
the reference's ``prototypes.pt`` and ``projection.pt`` there; the SimCLR
params from ``simclr_params.npz``, else the reference's ``projection.pt``
(either is pretrained first when none of its files is there); the k-means
clusterers from ``<out_dir>/clusterer_layer_{n}.npz``
(written by ``cli/pretrain.py``; missing ones raise). RepurposeGAN and
DatasetGAN need nothing saved.

``--method hfc_with_swav`` on ``p-horse-256`` (34 classes) and ``p-car-512``
(60) resolves to the generic config, whose XXS head outputs 12 channels: a
one-shot label past class 11 raises a ``ValueError`` before the fine-tune.
``--method datasetgan`` runs those models at every class.
"""

import argparse

from ganecdotes_torch.configs.mapper import resolve_method_alias
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

# the top-level evaluate.py's choices, then every other model key whose
# config file ships
MODELS = ["ffhq-256", "cat-256", "afhq-256", "horse-256", "car-512",
          "pidray-256", "pidray-pliers-256", "pidray-hammer-256",
          "pidray-powerbank-256", "pidray-wrench-256", "pidray-handcuffs-256",
          "ffhq-256-eg", "horse-256-rp", "church-256", "p-horse-256",
          "p-car-512"]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Script to evaluate saved self-supervised clustering model "
                    "for one-shot segmentation.")
    parser.add_argument("--model", default="ffhq-256", choices=MODELS, type=str)
    parser.add_argument(
        "--method", default="hfc_with_swav",
        choices=["hfc_with_swav", "hfc_with_simclr", "hfc_kmeans",
                 "repurposegan", "datasetgan"],
        type=str)
    parser.add_argument("--out_dir", default="results/evaluate_default/")
    parser.add_argument("--expt_desc", default="Testing Clustering Model")
    parser.add_argument("--num_test_samples", default=10, type=int)
    parser.add_argument(
        "--export_serving", default=None, metavar="PATH.ganex",
        help="export the trained serving program to a one-file artifact "
             "(not ported yet: raises)")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
             "PyTorch path)")
    return parser


def use_headless_matplotlib():
    """Plots must never grab a display; matplotlib is optional."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.export_serving:
        raise NotImplementedError(
            "--export_serving (a serving artifact) is not ported yet: "
            "ROADMAP §1 item 8")
    args.method = resolve_method_alias(args.method, args.model)
    use_headless_matplotlib()
    pipe = OneShotPipeline(
        out_dir=args.out_dir, exp_name=args.expt_desc, model=args.model,
        segmentor=args.method, num_test_samples=args.num_test_samples,
        device=args.device)
    if args.method not in ["datasetgan", "repurposegan"]:
        pipe.seg_config.train_hfc = False
        pipe.seg_config.hfc_prep_args["train"] = False
    if args.method == "hfc_kmeans":
        pipe.seg_config.hfc_prep_args["hfc_args"]["base_args"]["presaved"] = True
    pipe.run_pipeline()
    return pipe


if __name__ == "__main__":
    main()
