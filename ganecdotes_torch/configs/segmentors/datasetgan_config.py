"""DatasetGAN baseline: raw concat features + per-pixel MLP classifier (the
port's copy of ganecdotes_tpu/configs/segmentors/datasetgan_config.py)."""
seg_args = dict(size='S')

n_layers = 14
