"""Pre-train the self-supervised clustering model for one-shot segmentation
on the port (the flags of the top-level ``pretrain.py``, plus ``--device``),
then fine-tune and test the one-shot head.

    python -m ganecdotes_torch.cli.pretrain --model ffhq-256 \
        --method hfc_with_swav --out_dir results/pretrain_default_ffhq/

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device`` it raises. Training parameters are in the config files
under ganecdotes_torch/configs/segmentors/.
"""

import argparse

from ganecdotes_torch.cli.evaluate import MODELS, use_headless_matplotlib
from ganecdotes_torch.configs.mapper import resolve_method_alias
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline


def build_parser():
    parser = argparse.ArgumentParser(
        description="Script to pre-train self-supervised clustering model "
                    "for one-shot segmentation. User must specify the "
                    "StyleGAN model/ds for pre-training and method "
                    "{hfc_with_swav | hfc_with_simclr | hfc_kmeans}.")
    parser.add_argument("--model", default="ffhq-256", choices=MODELS, type=str)
    parser.add_argument(
        "--method", default="hfc_with_swav",
        choices=["hfc_with_swav", "hfc_with_simclr", "hfc_kmeans"], type=str)
    parser.add_argument("--out_dir", default="results/pretrain_default_ffhq/")
    parser.add_argument("--expt_desc", default="Testing Clustering Model")
    parser.add_argument("--num_test_samples", default=10, type=int)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
             "PyTorch path)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.method = resolve_method_alias(args.method, args.model)
    use_headless_matplotlib()
    pipe = OneShotPipeline(
        out_dir=args.out_dir, exp_name=args.expt_desc, model=args.model,
        segmentor=args.method, num_test_samples=args.num_test_samples,
        device=args.device)
    pipe.seg_config.train_hfc = True
    pipe.seg_config.hfc_prep_args["train"] = True
    pipe.run_pipeline()
    return pipe


if __name__ == "__main__":
    main()
