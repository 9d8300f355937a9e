"""ffhq-256 StyleGAN2 model config (the port's copy of
ganecdotes_tpu/configs/models/ffhq_256.py). No weights ship with the repo:
with no checkpoint at ``model_path`` the generator is initialised at random
from a seed."""

from ganecdotes_torch import ROOT_DIR

model_path = ROOT_DIR + '/checkpoints/standard/ffhq_256/stylegan2-ffhq-config-f.pt'

num_latents_for_mean = 4096
truncation = 0.7
image_size = 256
latent_dim = 512

gen_args = dict(size=image_size,
                style_dim=latent_dim,
                n_mlp=8)

is_baggan = False

# the one-shot sample and the test set; none ships with the repo: with no
# files there the pipeline synthesises its samples
sample_latents = ROOT_DIR + '/checkpoints/standard/ffhq_256/latents.pt'
sample_labels  = ROOT_DIR + '/checkpoints/standard/ffhq_256/labels.pt'
sample_images  = ROOT_DIR + '/checkpoints/standard/ffhq_256/images/'

one_shot_ind = 0

classes = ['background',
           'skin',
           'hair',
           'eye',
           'eyebrow',
           'nose',
           'mouth',
           'ear']
