"""pascal_horse_256 model config (the port's copy of
ganecdotes_tpu/configs/models/pascal_horse_256.py; every value unchanged)."""

from ganecdotes_torch import ROOT_DIR

# Pretrained generator checkpoint (rosinality g_ema layout, converted at load
# time by ganecdotes_torch.models.stylegan2.convert). Missing file => the
# pipeline falls back to a randomly initialized generator (no checkpoints
# ship with this repo).
model_path = ROOT_DIR + '/checkpoints/standard/pascal_horse_256/stylegan2-horse-config-f.pt'

num_latents_for_mean = 4096
truncation = 0.7
image_size = 256
latent_dim = 512

gen_args = dict(size=image_size,
                style_dim=latent_dim,
                n_mlp=8)

is_baggan = False

sample_latents = ROOT_DIR + '/checkpoints/standard/pascal_horse_256/latents.pt'
sample_labels  = ROOT_DIR + '/checkpoints/standard/pascal_horse_256/labels.pt'
sample_images  = ROOT_DIR + '/checkpoints/standard/pascal_horse_256/images/'
sample_noises  = ROOT_DIR + '/checkpoints/standard/pascal_horse_256/noises/'

one_shot_ind = 11

classes = ['background',
           'head',
           'leye',
           'reye',
           'lear',
           'rear',
           'muzzle',
           'lhorn',
           'rhorn',
           'torso',
           'neck',
           'lfuleg',
           'lflleg',
           'rfuleg',
           'rflleg',
           'lbuleg',
           'lblleg',
           'rbuleg',
           'rblleg',
           'tail',
           '20n',
           '21n',
           '22n',
           '23n',
           '24n',
           '25n',
           '26n',
           '27n',
           '28n',
           '29',
           'lfho',
           'rfho',
           'lbho',
           'rbho']
