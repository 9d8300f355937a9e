# Configuration options for training BagGAN-HQ on unlabeled PIDRay
# (value-compatible with the reference's
#  models/baggan/config/config_pidray_unlabeled.py:1-197)
import os
import time

from ganecdotes_torch import ROOT_DIR

# data locations --------------------------------------------------------------
out_dir = os.path.join(ROOT_DIR, "checkpoints", "baggan",
                       "pidray_baggan_presaved")

baggan_logger_name = "PIDRay TRAINER"
training_log_path = os.path.join(
    out_dir, time.strftime("ganseg_train_%m%d%Y_%H%M%S.log", time.localtime())
)

snap_dir = os.path.join(out_dir, "training_snaps")
losses_file = os.path.join(out_dir, "training_losses.npz")

net_version = "v4.0.1"
checkpoint_dir = os.path.join(out_dir, "models", "expt_%s" % net_version)

# experiment parameters -------------------------------------------------------
is_train = True
ds_type = "real"
mode = "bagganhq"
test_mode = None

image_size = 256
image_dims = 384, 384

print_freq = 400
display_freq = 2000
losses_to_print = ["g_gan", "d", "g_ppl"]
save_by_iter = False
save_epoch_freq = 20
save_only_latest = False
train_plot_layout = [5, 5]

# dataset ----------------------------------------------------------------------
ds_dir = ""
subset = "train"
batch_size = 20
serial_batches = False
num_threads = 20

# model parameters --------------------------------------------------------------
norm = "instance"
init_gain = 0.02
gpu_ids = [0]
num_channels = 3

latent_dim = 512
z_dim, w_dim = latent_dim, latent_dim

generator_params = dict(latent_dims=(z_dim, w_dim),
                        img_resolution=image_size,
                        mlp_layers=8,
                        mlp_lr=0.01,
                        img_chls=num_channels,
                        fir_filter=[1, 3, 3, 1],
                        res2chlmap=None)

disc_params = dict(img_resolution=image_size,
                   img_chls=num_channels,
                   res2chlmap=None,
                   with_q=False)

# training parameters -----------------------------------------------------------
start_epoch = 1
n_epochs = 750

continue_train = False
load_epoch = None
load_net = False
verbose = True

gan_mode = "wgangp"

# stylegan2 parameters
use_ppl = True
r1_lambda = 10
ppl_lambda = 2
path_batch_shrink = 2
ppl_decay = 0.01
d_reg_every = 16
g_reg_every = 4
mixing_prob = 0.9
chl_multiplier = 2
wandb = False
local_rank = 0

g_reg_ratio = g_reg_every / (g_reg_every + 1)
d_reg_ratio = d_reg_every / (d_reg_every + 1)

# adaptive discriminator augmentation
augment = True
augment_p = 0
ada_target = 0.6
ada_length = 500 * 1000
ada_freq = 256

# optimization
lr = 0.002
beta1 = 0.0

lr_policy = "linear"
lr_params = dict(epoch_count=1,
                 n_epochs=100,
                 n_epochs_decay=100,
                 lr_decay_iters=50)

PLOT_TRAINING_LOSS = True
DISPLAY_TRAINING_OUTPUT = True

# validation / testing ----------------------------------------------------------
valid_flag = True
valid_size = 100
valid_batch = 10
valid_dir = os.path.join(out_dir, "validation")
valid_tests = ["clutter_stats", "hist_scores", "hist_plot"]
clutter_valid_file = os.path.join(valid_dir, "clutter_valid_scores.npz")

test_size = 20
test_batch = 100
test_dir = os.path.join(out_dir, "test")

expt_desc = ("BagGAN-HQ on full PIDRay, wgangp loss, PPL regularization, "
             "ADA with random affine (PyTorch/CUDA trainer)")
