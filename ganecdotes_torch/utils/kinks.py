"""Leaky-ReLU kink decisions, recorded in one run and replayed in another.

A loss built on gradients through leaky ReLUs (R1, WGAN-GP, path length)
jumps where an input crosses 0, since the slope there goes from 1 to 0.2.
Two float32 runs of one step that sum in different orders can put an input
that lies within rounding of 0 on either side, and the loss then moves by
one kink's jump however small the rounding was. ``KinkDecisions`` records
the decisions ``x >= 0`` of one run and replays them in the other, so that
two such runs can be compared, and reports how close to 0 each decision it
changed lies.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GE = torch.ops.aten.ge.Scalar


class KinkDecisions(TorchDispatchMode):
    """While on, records (``masks`` None) or replays (``masks`` of a
    recording) every ``x >= 0`` taken of a 4-D floating tensor, in call
    order: the leaky ReLUs of the StyledConv composites' epilogues.

    ``masks`` holds the recorded decisions; in a replay ``flips`` gets, for
    each tensor whose decisions it changed, the largest |x| among the
    changed elements over the tensor's largest |x|."""

    def __init__(self, masks=None):
        super().__init__()
        self.replay = masks is not None
        self.masks = list(masks) if self.replay else []
        self.calls = 0
        self.flips = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func == GE and args[1] == 0 and args[0].dim() == 4
                and args[0].is_floating_point()):
            return out
        if not self.replay:
            self.masks.append(out)
        else:
            if self.calls >= len(self.masks) or self.masks[self.calls].shape != out.shape:
                raise RuntimeError("the replay decides other tensors than the recording")
            want = self.masks[self.calls]
            changed = want != out
            if bool(changed.any()):
                x = args[0].abs()
                self.flips.append(float(x[changed].max() / x.max()))
            out = want
        self.calls += 1
        return out
