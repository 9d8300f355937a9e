"""LARS as ``optax.lars`` computes it (the JAX SwAV step's optimizer,
ganecdotes_tpu/selfsup/swav.py:382-386). PyTorch has none.

``optax.lars(learning_rate, momentum, trust_coefficient)`` with its defaults
(weight decay 0, eps 0, no Nesterov) is the chain

    add_decayed_weights(0) -> scale_by_trust_ratio -> scale_by_learning_rate
    -> trace(momentum)

so per leaf, with step count n starting at 0:

    ratio = tc * |p| / |g|, or 1 where either norm is 0
    m <- -lr(n) * ratio * g + momentum * m;   p <- p + m

The learning rate is applied before the momentum trace, as optax does.
Params, gradients and updates are nested dicts and lists of tensors.
"""

from typing import Any, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of dicts and lists of the same shape.
    Dicts are walked in sorted key order, as ``jax.tree`` walks them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class LarsState(NamedTuple):
    count: int
    trace: Any


class LARS:
    """``init(params)`` and ``update(grads, state, params) -> (updates,
    state)``, as an optax transformation; ``learning_rate`` is a number or a
    function of the step count."""

    def __init__(self, learning_rate, momentum=0.9, trust_coefficient=0.001):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.trust_coefficient = trust_coefficient

    def init(self, params):
        return LarsState(0, tree_map(torch.zeros_like, params))

    def _lr(self, count):
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def update(self, grads, state, params):
        lr = self._lr(state.count)
        tc = self.trust_coefficient

        def scaled(g, p):
            p_norm = torch.linalg.vector_norm(p)
            g_norm = torch.linalg.vector_norm(g)
            ratio = torch.where((p_norm == 0) | (g_norm == 0),
                                torch.ones_like(p_norm), tc * p_norm / g_norm)
            return -lr * (g * ratio)

        updates = tree_map(scaled, grads, params)
        trace = tree_map(lambda u, m: u + self.momentum * m, updates,
                         state.trace)
        return trace, LarsState(state.count + 1, trace)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
