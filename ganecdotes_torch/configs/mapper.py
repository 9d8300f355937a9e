"""Config registry (port of ganecdotes_tpu/configs/mapper.py): the same keys
and the same model x method alias rules, with the losses and LR schedulers
mapped to the port's callables.

Every key resolves to a path in the port's ``configs/``, which holds a copy
of every config file the JAX package ships. Three model keys name a file
that neither package has ('ffhq-256-er', 'church-512', 'celeba-256', kept
for key-level parity with the reference): the pipeline raises
``NotImplementedError`` for them (``not_ported``).
"""

import os

from ganecdotes_torch import CONFIGS_DIR
from ganecdotes_torch.pipeline import losses as loss_lib
from ganecdotes_torch.pipeline import schedulers as sched_lib

# StyleGAN models
models = {
    "ffhq-256": os.path.join(CONFIGS_DIR, "models", "ffhq_256.py"),
    "ffhq-256-er": os.path.join(CONFIGS_DIR, "models", "ffhq_256_rp_earr.py"),
    "ffhq-256-eg": os.path.join(CONFIGS_DIR, "models", "ffhq_256_rp_eyeg.py"),
    "car-512": os.path.join(CONFIGS_DIR, "models", "lsun_car_512.py"),
    "cat-256": os.path.join(CONFIGS_DIR, "models", "lsun_cat_256.py"),
    "horse-256": os.path.join(CONFIGS_DIR, "models", "lsun_horse_256.py"),
    "horse-256-rp": os.path.join(CONFIGS_DIR, "models", "lsun_horse_256_rp.py"),
    "church-256": os.path.join(CONFIGS_DIR, "models", "lsun_church_256.py"),
    "church-512": os.path.join(CONFIGS_DIR, "models", "lsun_church_512.py"),
    "pidray-256": os.path.join(CONFIGS_DIR, "models", "pidray_bag_256.py"),
    "pidray-pliers-256": os.path.join(CONFIGS_DIR, "models", "pidray_pliers_256.py"),
    "pidray-hammer-256": os.path.join(CONFIGS_DIR, "models", "pidray_hammer_256.py"),
    "pidray-powerbank-256": os.path.join(
        CONFIGS_DIR, "models", "pidray_powerbank_256.py"
    ),
    "pidray-wrench-256": os.path.join(CONFIGS_DIR, "models", "pidray_wrench_256.py"),
    "pidray-handcuffs-256": os.path.join(
        CONFIGS_DIR, "models", "pidray_handcuffs_256.py"
    ),
    "celeba-256": os.path.join(
        CONFIGS_DIR, "models", "celebamask_ffhq_im_256_n_100.py"
    ),
    "p-horse-256": os.path.join(CONFIGS_DIR, "models", "pascal_horse_256.py"),
    "p-car-512": os.path.join(CONFIGS_DIR, "models", "pascal_car_512.py"),
    "afhq-256": os.path.join(CONFIGS_DIR, "models", "afhq_256.py"),
}

# Segmentor types: hfc_with_swav networks and the baselines
segmentors = {
    "repurposegan": os.path.join(CONFIGS_DIR, "segmentors", "repurposegan_config.py"),
    "datasetgan": os.path.join(CONFIGS_DIR, "segmentors", "datasetgan_config.py"),
    "hfc_with_swav": os.path.join(CONFIGS_DIR, "segmentors", "hfc_with_swav_config.py"),
    "hfc_with_simclr": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_simclr_config.py"
    ),
    "hfc_kmeans": os.path.join(CONFIGS_DIR, "segmentors", "hfc_kmeans_config.py"),
    "hfc_with_swav_cat": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_swav_cat_config.py"
    ),
    "hfc_with_swav_car": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_swav_car_config.py"
    ),
    "hfc_with_swav_ffhq": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_swav_ffhq_config.py"
    ),
    "hfc_with_swav_horse": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_swav_horse_config.py"
    ),
    "hfc_with_swav_pidray": os.path.join(
        CONFIGS_DIR, "segmentors", "hfc_with_swav_pidray_config.py"
    ),
}

# training method
trainer = {
    "supervised": os.path.join(CONFIGS_DIR, "trainers", "supervised_config.py"),
}

# tester modes (selected by string; the files are not read)
tester = {
    "iou": os.path.join(CONFIGS_DIR, "testers", "iou_config.py"),
    "roc": os.path.join(CONFIGS_DIR, "testers", "roc_config.py"),
    "prcurve": os.path.join(CONFIGS_DIR, "testers", "prcurve_config.py"),
    "dice": os.path.join(CONFIGS_DIR, "testers", "dice_config.py"),
    "conf_mat": os.path.join(CONFIGS_DIR, "testers", "conf_mat_config.py"),
    "all": os.path.join(CONFIGS_DIR, "testers", "all_config.py"),
}

losses = {
    "bce": loss_lib.bce_with_logits,
    "softmax": loss_lib.softmax_loss,
    "sigmoid": loss_lib.sigmoid_loss,
    "tanh": loss_lib.tanh_loss,
    "logloss": loss_lib.log_softmax_loss,
    "cross_entropy": loss_lib.cross_entropy,
}

lr_scheduler = {
    "step": sched_lib.step_lr,
    "plateau": sched_lib.plateau_lr,
    "cosine": sched_lib.cosine_lr,
}

def not_ported(kind, key, path):
    """Raise ``NotImplementedError`` for the ``kind`` ("model", "seg",
    "trainer") config ``key`` whose file at ``path`` is missing: the JAX
    package ships no such file either."""
    raise NotImplementedError(
        f"no {kind} config {key!r} ({path}): the JAX package ships no such "
        "file either, so there is nothing to port")


def resolve_method_alias(method, model):
    """model x method alias rules (pretrain.py and evaluate.py)."""
    if method == "hfc_with_swav":
        if model == "ffhq-256":
            return "hfc_with_swav_ffhq"
        if model == "cat-256":
            return "hfc_with_swav_cat"
        if model == "car-512":
            return "hfc_with_swav_car"
        if model == "horse-256":
            return "hfc_with_swav_horse"
        if "pidray" in model:
            return "hfc_with_swav_pidray"
    return method
