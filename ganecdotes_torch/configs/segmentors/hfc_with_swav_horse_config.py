"""hfc_with_swav_horse_config segmentor config (the port's copy of
ganecdotes_tpu/configs/segmentors/hfc_with_swav_horse_config.py; every value unchanged)."""

# SwAV segmentor config (horse)
n_layers = 13
n_hfc_layers = 6

train_hfc = False
layer_hf_dim = [512, 1024, 1024, 1024, 1024, 512, 256]
hlen = sum(layer_hf_dim)
nclasses = 512

hfc_prep_args = dict(
    # image augmentation via latent perturbation
    perturb_args=dict(truncation=0.7,
                      n_layers=n_hfc_layers,
                      n_samples=1,
                      layer_no=None,
                      perturb_std=[1.0]*n_hfc_layers),

    # swav clustering
    swav_args=dict(
                   num_epochs=50,
                   num_samples=1,
                   num_patches=5,
                   sampling_method='random',
                   patch_size=20000,
                   hf_interp='nearest',
                   # optimizer
                   warmup_epochs=100,
                   start_warmup=0.01,
                   use_scheduler=False,
                   base_lr=0.01,
                   final_lr=0.0001,
                   trust_coeff=0.01,
                   freeze_prototype_niters=313,
                   train_args=dict(lr=0.01,
                                   momentum=0.9),
                   # loss
                   projn_nw='linear',
                   temperature=0.01,
                   nprototypes=5000,
                   nclasses=nclasses,
                   hlen=hlen,
                   add_local_loss=False,
                   # display
                   plot_test_images=False,
                   epoch_print_freq=5,
                   max_masks=4),

    sinkhorn_args=dict(source_pdf='uniform',
                       niters=10,
                       eps=0.003),
    train=train_hfc,
    layer_hf_dim=[512, 1024, 1024, 1024, 1024, 512, 256]
)

seg_args = dict(size='XXS',
                in_ch=nclasses)
