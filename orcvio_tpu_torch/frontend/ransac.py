"""Batched 8-point fundamental-matrix RANSAC.

Counterpart of ``orcvio_tpu/frontend/ransac.py`` (reference: the
cv::findFundamentalMat RANSAC gate, image_processor.cpp:508,743-767): all
hypotheses are solved at once and scored against all correspondences, and
the best model's inliers form the gate.

Hypothesis indices are ``argmax(gumbel + logits)``, the Gumbel-max form of
the JAX package's ``jax.random.categorical`` draw. A caller may pass the
Gumbel noise itself (tests pass JAX's exact draws); otherwise it is drawn
from a ``torch.Generator``.
"""
from __future__ import annotations

import torch


def _eight_point(p1, p2):
    """F from 8 normalized correspondences per hypothesis.

    p1, p2: (Hyp, 8, 2) -> F (Hyp, 3, 3). The null vector of the design
    matrix comes from 3 fixed inverse-iteration solves on A^T A + eps I
    through an unrolled 9x9 Cholesky; no rank-2 projection (hypotheses are
    only scored by Sampson distance)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one],
                    dim=-1)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    eps = 1e-7 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = AtA + eps * torch.eye(9, dtype=A.dtype, device=A.device)
    L = _cholesky9(M)
    v = torch.ones((A.shape[0], 9), dtype=A.dtype, device=A.device)
    for _ in range(3):
        v = _chol_solve(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v.reshape(A.shape[0], 3, 3)


def _cholesky9(M):
    """Unrolled batched Cholesky of (H, n, n) SPD matrices."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[:, j, j]
        col = M[:, :, j]
        if j:
            s = s - torch.sum(L[:, j, :j] ** 2, dim=-1)
            col = col - torch.einsum("hk,hjk->hj", L[:, j, :j], L[:, :, :j])
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[:, j:, j] = (col / d[:, None])[:, j:]
    return L


def _chol_solve(L, b):
    """Solve L L^T x = b by unrolled forward/back substitution. b: (H, n)."""
    n = L.shape[-1]
    y = []  # built out of place, so that it batches under torch.func.vmap
    for i in range(n):
        done = torch.sum(L[:, i, :i] * torch.stack(y, -1), dim=-1) if i else 0
        y.append((b[:, i] - done) / L[:, i, i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        done = torch.sum(L[:, i + 1:, i] * torch.stack(x[i + 1:], -1),
                         dim=-1) if i < n - 1 else 0
        x[i] = (y[i] - done) / L[:, i, i]
    return torch.stack(x, -1)


def sampson_dist(F, p1, p2):
    """Sampson distance per correspondence: F (..., 3, 3), p (N, 2)."""
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)  # (N, 3)
    p2h = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    Fx1 = torch.einsum("...ij,nj->...ni", F, p1h)  # (..., N, 3)
    Ftx2 = torch.einsum("...ji,nj->...ni", F, p2h)
    x2Fx1 = torch.einsum("ni,...ni->...n", p2h, Fx1)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
             + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return (x2Fx1 ** 2) / torch.clamp(denom, min=1e-12)


def draw_gumbel(shape, generator: torch.Generator, dtype, device):
    """Standard Gumbel noise from `generator`."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


RANSAC_HYPOTHESES = 128  # hypotheses a frame draws


def ransac_fundamental(p1, p2, valid, gumbel=None, generator=None,
                       n_hyp: int = RANSAC_HYPOTHESES, thresh: float = 3e-5):
    """Inlier mask via batched 8-point RANSAC.

    p1, p2: (N, 2) normalized coords; valid: (N,) candidate mask; gumbel:
    optional (n_hyp, 8, N) noise, else drawn from `generator`; thresh is
    squared Sampson distance in normalized coords. Returns (inliers,
    best_F).
    """
    N = p1.shape[0]
    if gumbel is None:
        gumbel = draw_gumbel((n_hyp, 8, N), generator, p1.dtype, p1.device)
    logits = torch.where(valid, 0.0, float("-inf")).to(gumbel.dtype)
    idx = torch.argmax(gumbel + logits, dim=-1)  # (n_hyp, 8)
    F = _eight_point(p1[idx], p2[idx])  # (Hyp, 3, 3)
    d = sampson_dist(F, p1, p2)  # (Hyp, N)
    inl = (d < thresh) & valid[None, :]
    # best as a (1,) index: indexing with a 0-d tensor reads it to the host
    best = torch.argmax(torch.sum(inl, dim=1)).reshape(1)
    # degenerate cases: too few points to vote -> keep all valid
    enough = torch.sum(valid) >= 12
    return torch.where(enough, inl[best][0], valid), F[best][0]
