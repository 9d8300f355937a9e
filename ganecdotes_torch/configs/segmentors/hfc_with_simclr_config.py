"""SimCLR hidden-feature clustering config (the port's copy of
ganecdotes_tpu/configs/segmentors/hfc_with_simclr_config.py)."""
n_layers = 13
n_hfc_layers = 6

train_hfc = True
layer_hf_dim = [512, 1024, 1024, 1024, 1024, 512, 256]
hlen = sum(layer_hf_dim)  # 4864
nclasses = 512

hfc_prep_args = dict(
    perturb_args=dict(truncation=0.7,
                      n_layers=n_hfc_layers,
                      n_samples=1,
                      layer_no=None,
                      perturb_std=[1.0] * n_hfc_layers),

    simclr_args=dict(
                   num_iters=100,
                   batch_size=20,
                   patch_size=20000,
                   hf_interp='nearest',
                   trust_coeff=0.01,
                   train_args=dict(lr=0.01,
                                   momentum=0.9),
                   temperature=1.0,
                   nclasses=nclasses,
                   hlen=hlen,
                   epoch_print_freq=5,
                   max_masks=4),

    train=train_hfc,
    layer_hf_dim=layer_hf_dim,
)

seg_args = dict(size='XS',
                in_ch=nclasses)
