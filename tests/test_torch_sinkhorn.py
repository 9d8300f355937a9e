"""The port's Sinkhorn-Knopp (ops/sinkhorn.py) held against the JAX package's
forms: the jnp potentials iteration of selfsup/swav.py and the streaming
Pallas kernel of ops/sinkhorn_pallas.py in interpret mode.

On the CPU the wrapper takes the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerance: 1e-4 absolute on codes in [0, 1], the JAX package's own for the
online-max kernel against the two-pass logsumexp (tests/test_selfsup.py:
191-195): at eps = 0.005 the logits are ~200x the scores, where float32
reassociation shows in the near-one-hot codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.ops.sinkhorn_pallas import sinkhorn_knopp_pallas
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_torch.ops import _build
from ganecdotes_torch.ops.sinkhorn import sinkhorn_knopp, sinkhorn_knopp_ref
from ganecdotes_torch.selfsup import swav as tswav

TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(b, k, seed):
    rs = np.random.RandomState(seed)
    scores = rs.randn(b, k).astype(np.float32)
    r = rs.rand(k).astype(np.float32) + 0.1
    c = rs.rand(b).astype(np.float32) + 0.1
    return scores, r / r.sum(), c / c.sum()


@pytest.mark.parametrize("b,k,niters,eps", [
    (160, 136, 3, 0.05), (64, 128, 10, 0.005), (64, 128, 0, 0.05),
    (96, 72, 0, 0.005)])
def test_sinkhorn_ref_matches_jax(b, k, niters, eps):
    """Non-uniform r and c; the JAX jnp path and both Pallas variants."""
    scores, r, c = _inputs(b, k, seed=b + k + niters)
    got = sinkhorn_knopp_ref(torch.from_numpy(scores), niters, eps,
                             torch.from_numpy(r), torch.from_numpy(c)).numpy()
    jargs = (jnp.asarray(scores), niters, eps, jnp.asarray(r), jnp.asarray(c))
    np.testing.assert_allclose(got, np.asarray(jswav.sinkhorn_knopp(*jargs)),
                               **TOL)
    # the twopass variant has no row pass at niters = 0 (see the next test)
    variants = ("fused", "twopass") if niters else ("fused",)
    for variant in variants:
        want = np.asarray(sinkhorn_knopp_pallas(*jargs, variant=variant))
        np.testing.assert_allclose(got, want, **TOL, err_msg=variant)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-4)


def test_jax_twopass_sinkhorn_skips_the_row_pass_at_zero_iterations():
    """A fault of the JAX package, pinned: with niters = 0 the twopass Pallas
    variant returns exp(scores/eps - log c), unnormalised, where the jnp path
    and the fused variant (and the port) return the row softmax. The shipped
    path never meets it: configs run niters >= 1, and (20000, 5000) takes
    the fused variant."""
    scores, r, c = _inputs(16, 128, seed=3)
    eps = 0.5
    got = np.asarray(sinkhorn_knopp_pallas(
        jnp.asarray(scores), 0, eps, jnp.asarray(r), jnp.asarray(c),
        variant="twopass"))
    np.testing.assert_allclose(got, np.exp(scores / eps - np.log(c)[:, None]),
                               rtol=1e-4)
    assert np.abs(got.sum(axis=1) - 1).max() > 1.0


def test_sinkhorn_wrapper_takes_the_plain_version_on_the_cpu():
    scores, r, c = _inputs(40, 24, seed=5)
    args = (torch.from_numpy(scores), 4, 0.05, torch.from_numpy(r),
            torch.from_numpy(c))
    _build.reset_launches()
    torch.testing.assert_close(sinkhorn_knopp(*args), sinkhorn_knopp_ref(*args),
                               atol=0, rtol=0)
    assert _build.LAUNCHES["sinkhorn_knopp"] == 0


def test_swav_sinkhorn_codes_carry_no_gradient():
    scores, r, c = _inputs(24, 16, seed=6)
    s = torch.from_numpy(scores).requires_grad_(True)
    q = tswav.sinkhorn_knopp(s * 2.0, 3, 0.05, torch.from_numpy(r),
                             torch.from_numpy(c))
    assert not q.requires_grad


def test_sinkhorn_ref_extreme_scores_stay_finite():
    """Scores of +-5 at eps = 0.005 put the logits at +-1000, where a plain
    exp(scores/eps) overflows float32."""
    rs = np.random.RandomState(7)
    scores = torch.from_numpy((rs.randn(100, 50) * 5).astype(np.float32))
    q = sinkhorn_knopp_ref(scores, 10, 0.005, torch.ones(50) / 50,
                           torch.ones(100) / 100)
    assert torch.isfinite(q).all()
    torch.testing.assert_close(q.sum(dim=1), torch.ones(100), atol=1e-5,
                               rtol=0)
