"""The numbers that decide ``correct``: how far what the program served
lies from what the reference computes for the same inputs.

- ``relative_gap``: the largest elementwise difference over the largest
  magnitude of the reference;
- ``argmax_gap``: for a served choice (a label) at each position, how far
  the reference's score of that choice lies below the reference's best
  score there, over the largest score magnitude. A label that ties the best
  reads 0, so a flip between near-equal scores costs no more than the
  rounding that caused it; a wrong label reads about the scores' spread.

Both are taken in float64 and return ``inf`` for a shape mismatch, an
out-of-range choice or a value that is not finite.
"""

import math

import torch


def relative_gap(got, ref):
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    got = got.to(torch.float64)
    ref = ref.to(device=got.device, dtype=torch.float64)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def argmax_gap(chosen, ref_scores):
    """``chosen`` (...) integer choices, ``ref_scores`` (..., C)."""
    if tuple(chosen.shape) != tuple(ref_scores.shape[:-1]):
        return math.inf
    scores = ref_scores.to(torch.float64)
    chosen = chosen.to(device=scores.device, dtype=torch.long)
    if bool((chosen < 0).any()) or bool((chosen >= scores.shape[-1]).any()):
        return math.inf
    best = scores.max(dim=-1).values
    got = scores.gather(-1, chosen[..., None])[..., 0]
    return float((best - got).max() / scores.abs().max().clamp(min=1e-30))
