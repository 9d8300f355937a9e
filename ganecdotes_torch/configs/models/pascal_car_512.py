"""pascal_car_512 model config (the port's copy of
ganecdotes_tpu/configs/models/pascal_car_512.py; every value unchanged)."""

from ganecdotes_torch import ROOT_DIR

# Pretrained generator checkpoint (rosinality g_ema layout, converted at load
# time by ganecdotes_torch.models.stylegan2.convert). Missing file => the
# pipeline falls back to a randomly initialized generator (no checkpoints
# ship with this repo).
model_path = ROOT_DIR + '/checkpoints/standard/pascal_car_512/stylegan2-car-config-f.pt'

num_latents_for_mean = 4096
truncation = 0.7
image_size = 256
latent_dim = 512

gen_args = dict(size=image_size,
                style_dim=latent_dim,
                n_mlp=8)

is_baggan = False

sample_latents = ROOT_DIR + '/checkpoints/standard/pascal_car_512/latents.pt'
sample_labels  = ROOT_DIR + '/checkpoints/standard/pascal_car_512/labels.pt'
sample_images  = ROOT_DIR + '/checkpoints/standard/pascal_car_512/images/'
sample_noises  = ROOT_DIR + '/checkpoints/standard/pascal_car_512/noises/'

one_shot_ind = 0

classes = ['background','frontside','leftside','rightside','backside','roofside','leftmirror','rightmirror','fliplate','bliplate'] \
          + [f'door_{i}' for i in range(1, 10+1)] \
          + [f'wheel_{i}' for i in range(1, 10+1)] \
          + [f'headlight_{i}' for i in range(1, 10+1)] \
          + [f'window_{i}' for i in range(1, 20+1)]
