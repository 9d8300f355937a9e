"""The control of the training cells: the plain reference trainer, rounding
every matmul and convolution operand to ``fmt``, trained in the program's
place through the same feed (``benchmark/control.py``)."""

import torch


class Control:
    def __init__(self, fmt, reference, system):
        self.fmt, self.reference, self.system = fmt, reference, system

    def build(self, cfg, weights, seed, device, out_dir):
        t = self.reference.Trainer(cfg, weights, device, fmt=self.fmt)
        t.device, t.last = device, {}
        return t

    def loader(self, cfg, paths):
        return self.system.loader(cfg, paths)

    def step(self, t, batch, it, d=None):
        # an iteration the program draws for itself (no ``d``) reuses the
        # first draws handed in, which hold every step kind's
        if d is None:
            d = t.first_draws
        elif not hasattr(t, "first_draws"):
            t.first_draws = d
        t.last = t.iteration(it, torch.as_tensor(batch).to(t.device), d)

    def losses(self, t, it, cfg):
        return dict(t.last)

    def params(self, t):
        return t.params()

    def watch_first_grads(self, t):
        return t.first_grads

    def watch_first_image(self, t):
        return t.first_image

    def unwatch(self, t):
        pass
