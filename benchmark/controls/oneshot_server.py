"""The control of the serving cells: the plain reference, rounding every
matmul and convolution operand to ``fmt``, served in the program's place
(``benchmark/control.py``)."""

import torch


class Control:
    def __init__(self, fmt, reference, system):
        self.fmt, self.reference, self.system = fmt, reference, system

    def build(self, cfg, weights, seed, device):
        ref = self.reference.Reference(cfg, weights, device, fmt=self.fmt)
        ref.mean_w = ref.mean_latent(self.system.mean_latent_z(cfg, seed))
        return ref

    def mean_latent_z(self, cfg, seed):
        return self.system.mean_latent_z(cfg, seed)

    def serve(self, ref, z):
        with torch.no_grad():
            img, logits, emb0 = ref.request(z, ref.mean_w, rows=4)
        return img, logits.argmax(-1), emb0.argmax(-1)[None]
