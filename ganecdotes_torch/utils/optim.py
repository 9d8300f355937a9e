"""Adam in optax's order of operations, over a list of tensors (the
optimizer of the BagGAN trainer and of the one-shot fine-tune)."""

import torch


class Adam:
    """``optax.inject_hyperparams(optax.adam)`` over a list of tensors,
    updated in place: m = (1-b1) g + b1 m, v = (1-b2) g^2 + b2 v, and
    p += -lr * m_hat / (sqrt(v_hat) + eps) with the bias-corrected moments,
    in optax's order of operations. ``lr`` may change between steps;
    ``count`` is the number of updates taken (optax's step count)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * g.square() + self.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(u * (-self.lr))
