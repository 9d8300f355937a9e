"""K-means hidden-feature clustering config (the port's copy of
ganecdotes_tpu/configs/segmentors/hfc_kmeans_config.py)."""
n_layers = 13
n_hfc_layers = 5

# clusters per StyleGAN block, typically powers of 2
clusters_per_layer = [4, 8, 16, 32, 64]
train_hfc = True

hfc_prep_args = dict(
    perturb_args=dict(truncation=0.7,
                      n_layers=n_hfc_layers,
                      n_samples=4,
                      perturb_std=[1.0] * n_hfc_layers),

    hfc_algo='hfc_kmeans',   # {'hfc_kmeans' | 'hfc_kmeans_hier'}
    hfc_args=dict(
        kmeans_args=dict(verbose=0),
        base_args=dict(out_dir=None,
                       n_layers=n_hfc_layers,
                       clusters_per_layer=clusters_per_layer,
                       out_size=256,
                       presaved=not train_hfc)
    ),
    hier_encode=False,
    hle_samples=100,
    train=train_hfc,
)

seg_args = dict(size='S',
                in_ch=sum(clusters_per_layer))
