"""Interactive GUI for on-the-fly one-shot segmentation on the port (the
flags of the top-level ``run_on_the_fly_segmentor_gui.py``, plus
``--device``).

    python -m ganecdotes_torch.cli.gui --model ffhq-256 --out_dir data/gui_demo/

Builds the generic ``hfc_with_swav`` pipeline (as the reference does, the
per-model alias is not taken), with SwAV loaded, not pretrained
(``<out_dir>/swav_params.npz`` or the reference's ``prototypes.pt`` and
``projection.pt``; pretrained first when none is there), 8 test samples and
100 fine-tune epochs, runs its setup block and opens
``InteractiveLabellerGUI``. The window needs matplotlib and cv2, and blocks
only on an interactive matplotlib backend: under Agg (no display) the
command returns after the set-up. Runs on the CUDA card unless ``--device
cpu`` is given; without a card and without ``--device`` it raises.
"""

import argparse

from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline

MODELS = ["ffhq-256", "cat-256", "afhq-256", "horse-256", "car-512",
          "pidray-256", "pidray-pliers-256", "pidray-hammer-256",
          "pidray-powerbank-256", "pidray-wrench-256", "pidray-handcuffs-256"]
FINETUNE_EPOCHS = 100  # fewer than the trainer config's: the loop stays responsive


def build_parser():
    parser = argparse.ArgumentParser(
        description="Script to run an interactive GUI for on-the-fly one-shot "
                    "segmentation. The GUI allows labelling StyleGAN images and "
                    "synthesizes new annotated images on-the-fly.")
    parser.add_argument("--model", default="ffhq-256", choices=MODELS, type=str)
    parser.add_argument("--out_dir", default="data/gui_demo/",
                        help="Expt. directory with saved model + output")
    parser.add_argument("--expt_desc",
                        default="Interactive GUI for On-the-fly Segmentation")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
             "PyTorch path)")
    return parser


def build_pipeline(model, out_dir, expt_desc="", device=None, ops=KERNELS):
    """The GUI's pipeline after its setup block."""
    pipe = OneShotPipeline(out_dir=out_dir, exp_name=expt_desc, model=model,
                           segmentor="hfc_with_swav", num_test_samples=8,
                           device=device, ops=ops)
    pipe.seg_config.train_hfc = False
    pipe.seg_config.hfc_prep_args["train"] = False
    pipe.trainer_config.num_epochs = FINETUNE_EPOCHS
    pipe.run_pipeline(blocks_to_run=["setup"])
    return pipe


def main(argv=None):
    from ganecdotes_torch.gui.interactive_labeller import InteractiveLabellerGUI

    args = build_parser().parse_args(argv)
    pipe = build_pipeline(args.model, args.out_dir, args.expt_desc, args.device)
    return InteractiveLabellerGUI(one_shot_learner=pipe, cmap="jet")


if __name__ == "__main__":
    main()
