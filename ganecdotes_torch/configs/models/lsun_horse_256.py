"""lsun_horse_256 model config (the port's copy of
ganecdotes_tpu/configs/models/lsun_horse_256.py; every value unchanged)."""

from ganecdotes_torch import ROOT_DIR

# Pretrained generator checkpoint (rosinality g_ema layout, converted at load
# time by ganecdotes_torch.models.stylegan2.convert). Missing file => the
# pipeline falls back to a randomly initialized generator (no checkpoints
# ship with this repo).
model_path = ROOT_DIR + '/checkpoints/standard/horse_256/stylegan2-horse-config-f.pt'

num_latents_for_mean = 4096
truncation = 0.7
image_size = 256
latent_dim = 512

gen_args = dict(size=image_size,
                style_dim=latent_dim,
                n_mlp=8)

is_baggan = False

sample_latents = ROOT_DIR + '/checkpoints/standard/horse_256/latents.pt'
sample_labels  = ROOT_DIR + '/checkpoints/standard/horse_256/labels.pt'
sample_images  = ROOT_DIR + '/checkpoints/standard/horse_256/images/'

one_shot_ind = 4

classes = ['background',
           'f_leg',
           'b_leg',
           'torso',
           'neck',
           'tail',
           'head',
           'rider']
