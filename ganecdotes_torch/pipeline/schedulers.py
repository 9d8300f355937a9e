"""LR multiplier schedules (port of ganecdotes_tpu/pipeline/schedulers.py).

Each factory returns ``f(epoch) -> multiplier`` of the base lr, the
functional forms of StepLR, CosineAnnealingLR and ReduceLROnPlateau as the
supervised fine-tune uses them.
"""

import math

import numpy as np


def step_lr(step_size, gamma=0.1):
    def sched(epoch):
        return gamma ** (epoch // step_size)

    return sched


def cosine_lr(T_max, eta_min=0.0):
    # in float32, in the order the JAX schedule computes it
    def sched(epoch):
        frac = np.float32(min(epoch, T_max)) / np.float32(T_max)
        cos = np.cos(np.float32(math.pi) * frac)
        return float(np.float32(eta_min)
                     + np.float32((1.0 - eta_min) * 0.5) * (np.float32(1.0) + cos))

    return sched


def plateau_lr(patience=10, factor=0.1, threshold=1e-4, threshold_mode="rel",
               cooldown=0, min_lr_mult=0.0, eps=1e-8, **_):
    """Stateful plateau scheduler: ``.step(loss)`` returns the multiplier.

    ``torch.optim.lr_scheduler.ReduceLROnPlateau`` in mode 'min': a relative
    improvement threshold by default (``loss < best * (1 - threshold)``), a
    cooldown after each reduction during which bad epochs do not count, a
    floor (``min_lr_mult``, torch's min_lr as a fraction of the base lr), and
    torch's ``eps`` rule (a reduction smaller than eps is skipped).
    """

    class _Plateau:
        def __init__(self):
            self.best = float("inf")
            self.bad = 0
            self.cooldown_counter = 0
            self.mult = 1.0

        def _is_better(self, loss):
            if threshold_mode == "rel":
                return loss < self.best * (1.0 - threshold)
            return loss < self.best - threshold

        def step(self, loss):
            loss = float(loss)
            if self._is_better(loss):
                self.best = loss
                self.bad = 0
            else:
                self.bad += 1
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.bad = 0
            if self.bad > patience:
                new_mult = max(self.mult * factor, min_lr_mult)
                if self.mult - new_mult > eps:
                    self.mult = new_mult
                self.cooldown_counter = cooldown
                self.bad = 0
            return self.mult

        def __call__(self, _epoch):
            return self.mult

    return _Plateau()
