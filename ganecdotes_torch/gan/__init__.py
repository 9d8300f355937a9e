"""BagGAN-HQ training (port of ganecdotes_tpu/gan): losses, ADA, the image
pool, trainer."""

from ganecdotes_torch.gan.ada import AdaptiveAugment, augment, sample_affine, sample_color
from ganecdotes_torch.gan.image_pool import ImagePool
from ganecdotes_torch.gan.losses import (
    dice_loss,
    gan_loss,
    gradient_penalty,
    logistic_loss,
    nonsaturating_loss,
    normal_nll_loss,
    path_length_penalty,
    r1_penalty,
)
from ganecdotes_torch.gan.train import (
    BagGANDraws,
    BagGANHQ,
    GANBaseModel,
    draw_step_inputs,
    get_scheduler,
    initialize_params,
)
