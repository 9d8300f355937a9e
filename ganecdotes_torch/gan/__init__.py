"""BagGAN-HQ training (port of ganecdotes_tpu/gan): losses, ADA, trainer."""

from ganecdotes_torch.gan.ada import AdaptiveAugment, augment, sample_affine, sample_color
from ganecdotes_torch.gan.losses import (
    gan_loss,
    gradient_penalty,
    path_length_penalty,
    r1_penalty,
)
from ganecdotes_torch.gan.train import (
    BagGANDraws,
    BagGANHQ,
    GANBaseModel,
    draw_step_inputs,
    get_scheduler,
)
