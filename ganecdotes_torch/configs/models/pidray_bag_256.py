"""pidray_bag_256 model config (the port's copy of
ganecdotes_tpu/configs/models/pidray_bag_256.py; every value unchanged)."""

from ganecdotes_torch import ROOT_DIR, CONFIGS_DIR

# BagGAN-HQ generator trained on X-ray baggage imagery (PIDRay); the
# generator is built+loaded through ganecdotes_torch.models.baggan.
config_path = CONFIGS_DIR + '/models/baggan/config_pidray_unlabeled.py'

num_latents_for_mean = 4096
truncation = 0.9
image_size = 256
latent_dim = 512

gen_args = dict(size=256,
                style_dim=512,
                n_mlp=8,
                channel_multiplier=2,
                blur_kernel=[1, 3, 3, 1],
                lr_mlp=0.01)

is_baggan = True

sample_latents = ROOT_DIR + '/checkpoints/baggan/pidray_256/latents.pt'
sample_images  = ROOT_DIR + '/checkpoints/baggan/pidray_256/images/'
sample_labels  = ROOT_DIR + '/checkpoints/baggan/pidray_256/labels.pt'

one_shot_ind = 0

classes = ['background',
           'bag',
           'metal',
           'liquid',
           'hammer',
           'tools',
           'organic',
           'weapon']
