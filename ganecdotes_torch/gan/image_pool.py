"""History buffer of generated images (port of ganecdotes_tpu/gan/image_pool.py,
the reference ImagePool, models/baggan/gan_util.py:416-487).

A capacity-bounded pool of earlier generated images: ``query`` returns, per
image, either the fresh image (p = 0.5) or a random pooled one, which the
fresh image then replaces. The decisions come from an explicit
``np.random.RandomState(seed)``, in the JAX pool's order of draws, so the
same seed makes the same picks; the images stay tensors on their device.
"""

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size, seed=0):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images = []
        self._rng = np.random.RandomState(seed)

    def query(self, images):
        """images: (B, H, W, C) tensor. Returns a (B, H, W, C) tensor,
        detached (the reference pools ``.data``)."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images.detach():
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.clone())
                out.append(image)
            elif self._rng.uniform() > 0.5:
                idx = self._rng.randint(0, self.pool_size)
                out.append(self.images[idx])
                self.images[idx] = image.clone()
            else:
                out.append(image)
        return torch.stack(out)
