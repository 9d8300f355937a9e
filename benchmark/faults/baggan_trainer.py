"""Faults planted under a training cell's timed path (``control.py
--fault``, and the CPU tests): each wraps the loop body's call into the
trainer, and a run with one of them has to come out not correct. A
training cell runs on one card, so a lost exchange between cards has no
place here."""

import torch


def state_unchanged(step):
    """The iteration returns with the trainer's state as it was."""
    def broken(gan, batch, it, d=None):
        pass
    return broken


def half_batch(step):
    """Half of the batch left out, the PPL's too: the means taken over the
    rest (rounded down to whole groups of D's minibatch deviation, 4)."""
    def broken(gan, batch, it, d=None):
        h = batch.shape[0] // 2
        if h > 4:
            h -= h % 4

        def cut(x):
            if isinstance(x, torch.Tensor):
                return x[:h]
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v) for v in x)
            return x

        if d is not None:
            d = {k: v if k == "inject_index" else cut(v) for k, v in d.items()}
        step(gan, batch[:h], it, d)
    return broken


def gradient_altered(step):
    """The first tensor's gradient of each D-optimiser step scaled by 1.5
    where it is produced."""
    def broken(gan, batch, it, d=None):
        opt = gan.optimizer_d
        orig = opt.step

        def altered(grads):
            grads = list(grads)
            grads[0] = grads[0] * 1.5
            return orig(grads)

        opt.step = altered
        try:
            step(gan, batch, it, d)
        finally:
            opt.step = orig
    return broken


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, gradient_altered)}
