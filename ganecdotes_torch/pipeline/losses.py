"""The fine-tune's loss registry (port of ganecdotes_tpu/pipeline/losses.py).

Each is ``f(logits, target) -> scalar`` over NHWC logits (B, H, W, C) with
integer targets (B, H, W) for the cross entropy.
"""

import torch
import torch.nn.functional as F


def cross_entropy(logits, target):
    """nn.CrossEntropyLoss (mean over pixels), NHWC logits, int targets."""
    c = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, c), target.reshape(-1).long())


def bce_with_logits(logits, target):
    """nn.BCEWithLogitsLoss (targets of the logits' shape, float)."""
    return F.binary_cross_entropy_with_logits(logits, target.to(logits.dtype))


# the reference maps these names to plain activation modules (a quirk of its
# loss registry); kept callable for key parity
def softmax_loss(logits, target):
    del target
    return torch.softmax(logits, dim=-1)


def sigmoid_loss(logits, target):
    del target
    return torch.sigmoid(logits)


def tanh_loss(logits, target):
    del target
    return torch.tanh(logits)


def log_softmax_loss(logits, target):
    del target
    return torch.log_softmax(logits, dim=-1)
