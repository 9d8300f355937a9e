"""Log-domain Sinkhorn-Knopp codes for SwAV (port of
ganecdotes_tpu/ops/sinkhorn_pallas.py).

``sinkhorn_knopp_ref`` is the plain version: the potentials iteration of
ganecdotes_tpu/selfsup/swav.py:225-245 written with ``torch.logsumexp``.
``sinkhorn_knopp`` launches the streaming CUDA kernel (csrc/sinkhorn.cu) on
a CUDA tensor and takes the plain version only for a tensor on the CPU.
No gradient: SwAV uses the codes as constant targets (the JAX step wraps
them in stop_gradient), so ``sinkhorn_knopp`` refuses scores that need a
gradient while grad mode is on, rather than hand back codes cut from the
graph; callers pass ``scores.detach()``.
"""

import torch

from ganecdotes_torch.ops import _build

KERNEL = "sinkhorn_knopp"
ROWS_PER_CHUNK = 128  # rows one block of the column pass streams


def sinkhorn_knopp_ref(scores, niters, eps, r, c):
    """Codes (B, K) from scores (B, K), prototype marginal r (K,) and pixel
    marginal c (B,): u = log r - lse_b(base + v), v = log c - lse_k(base + u)
    from v = 0, then the per-pixel renormalised exp(base + u + v)."""
    with torch.no_grad():
        base = (scores / eps).T  # (K, B)
        base = base - torch.logsumexp(base.reshape(-1), dim=0)
        log_r, log_c = torch.log(r), torch.log(c)
        u = torch.zeros(scores.shape[1], dtype=base.dtype, device=base.device)
        v = torch.zeros(scores.shape[0], dtype=base.dtype, device=base.device)
        for _ in range(int(niters)):
            u = log_r - torch.logsumexp(base + v[None, :], dim=1)
            v = log_c - torch.logsumexp(base + u[:, None], dim=0)
        log_q = base + u[:, None] + v[None, :]
        return torch.exp(log_q - torch.logsumexp(log_q, dim=0, keepdim=True)).T


def sinkhorn_knopp(scores, niters, eps, r, c):
    """Kernel on CUDA tensors (scores (B, K), r (K,), c (B,), float32,
    contiguous); the plain version on CPU tensors. No gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (scores, r, c) if isinstance(t, torch.Tensor)):
        raise ValueError(f"{KERNEL}: the codes have no gradient; pass detached "
                         "scores and marginals")
    if scores.device.type == "cpu":
        return sinkhorn_knopp_ref(scores, niters, eps, r, c)
    _build.check_tensor(KERNEL, scores, "scores", ndim=2)
    b, k = scores.shape
    _build.check_tensor(KERNEL, r, "r", ndim=1, device=scores.device)
    _build.check_tensor(KERNEL, c, "c", ndim=1, device=scores.device)
    if r.shape[0] != k or c.shape[0] != b:
        raise ValueError(f"{KERNEL}: r {tuple(r.shape)} and c {tuple(c.shape)} "
                         f"do not match scores {tuple(scores.shape)}")
    if niters < 0 or b == 0 or k == 0:
        raise ValueError(f"{KERNEL}: niters {niters} at shape {(b, k)}")
    q = torch.empty_like(scores)
    nchunks = -(-b // ROWS_PER_CHUNK)
    scratch = torch.empty(k + 2 * b + 2 * nchunks * k, dtype=torch.float32,
                          device=scores.device)
    u, t, v, part_m, part_s = torch.split(
        scratch, [k, b, b, nchunks * k, nchunks * k])
    _build.launch(
        KERNEL, "gk_sinkhorn_knopp",
        _build.ptr(scores), _build.ptr(r), _build.ptr(c), _build.ptr(q),
        _build.ptr(u), _build.ptr(t), _build.ptr(v), _build.ptr(part_m),
        _build.ptr(part_s), b, k, int(niters), float(1.0 / eps),
        ROWS_PER_CHUNK, nchunks, _build.stream_of(scores),
    )
    return q
