"""RepurposeGAN baseline: raw concat features + dilated FCN head (the
port's copy of ganecdotes_tpu/configs/segmentors/repurposegan_config.py)."""
seg_args = dict(size='XS')

n_layers = 13
