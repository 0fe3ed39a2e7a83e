"""Dense linear-algebra helpers for the filter, batched and masked.

Counterpart of ``orcvio_tpu/math/linalg.py`` (reference:
math_utils.hpp:287,315 nullspace projection, orcvio.cpp:1664-1683 SPQR
compression, orcvio.cpp:486-494 chi-square table). Padded (masked-out)
rows are exact zero rows, harmless through the Householder reflections,
the compressions and S = H P H^T + sigma^2 I. A failed factorization gives
NaN, as the JAX package's does on the CPU: the ``*_ex`` solvers' error
flags are turned into NaN on the device, never read by the host.
"""
from __future__ import annotations

import numpy as np
import torch

_CHI2_MAX_DOF = 500


def chi_squared_table(confidence=0.95, max_dof=_CHI2_MAX_DOF) -> np.ndarray:
    """chi^2 inverse-CDF lookup, index = dof (0 unused), from scipy on the
    host. Ref: orcvio.cpp:486-494."""
    from scipy.stats import chi2

    table = np.zeros(max_dof + 1)
    table[1:] = chi2.ppf(confidence, np.arange(1, max_dof + 1))
    return table


def nullspace_project(H_f, H_x, r):
    """Project (H_x, r) onto the left nullspace of H_f. Ref: math_utils.hpp:315.

    H_f: (..., m, k), H_x: (..., m, d), r: (..., m). Returns (H_x', r') with
    m - k meaningful rows, padded back to m rows with zeros. The k
    Householder reflections are applied to [H_x | r] directly (the JAX
    package's unrolled branch for small k); the output differs from a QR
    basis only by an orthogonal row transform, which S, the chi-square
    test and the EKF update are invariant to.
    """
    m, k = H_f.shape[-2:]
    M = torch.cat([H_x, r[..., None]], dim=-1)  # (..., m, d+1)
    A = H_f
    rows = torch.arange(m, device=H_f.device)
    for j in range(k):
        x = torch.where(rows >= j, A[..., :, j], 0.0)
        nx = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., j] >= 0, 1.0, -1.0).to(x.dtype)
        v = torch.where(rows == j, x + (sign * nx)[..., None], x)
        vtv = torch.sum(v * v, dim=-1)
        beta = torch.where(vtv > 1e-30, 2.0 / torch.where(vtv > 1e-30, vtv, 1.0),
                           0.0)
        bv = (beta[..., None] * v)[..., :, None]
        A = A - bv * (v[..., None, :] @ A)
        M = M - bv * (v[..., None, :] @ M)
    keep = (rows < (m - k))[:, None]
    Hp = torch.where(keep, torch.roll(M[..., :-1], -k, dims=-2), 0.0)
    rp = torch.where(keep[:, 0], torch.roll(M[..., -1], -k, dims=-1), 0.0)
    return Hp, rp


def chi2_gamma(S, r):
    """gamma = r^T S^{-1} r for small PD S, by unrolled symmetric elimination
    of the bordered matrix [[S, r], [r^T, 0]].

    S: (..., m, m), r: (..., m). A non-positive pivot (impossible for a true
    PD S, possible under f32 roundoff) gives +inf, so the gate rejects."""
    m = S.shape[-1]
    border = torch.cat([r[..., None, :], torch.zeros_like(r[..., :1])[..., None]],
                       dim=-1)
    T = torch.cat([torch.cat([S, r[..., :, None]], dim=-1), border], dim=-2)
    ok = torch.ones(S.shape[:-2], dtype=torch.bool, device=S.device)
    for k_ in range(m):
        d = T[..., k_, k_]
        ok = ok & (d > 0)
        c = T[..., :, k_]
        T = T - c[..., :, None] * (c[..., None, :]
                                   / torch.where(d > 0, d, 1.0)[..., None, None])
    gamma = -T[..., m, m]
    return torch.where(ok, gamma, torch.inf)


def qr_compress(H, r):
    """Compress a tall stacked Jacobian by thin QR. Ref: orcvio.cpp:1664-1683
    (SPQR). H (m, d), r (m,). Returns (R, Q1^T r), shapes ((q, d), (q,)),
    q = min(m, d)."""
    Q, R = torch.linalg.qr(H, mode="reduced")
    return R, Q.T @ r


def chol_compress(H, r):
    """Gram-Cholesky compression: (H_thin, r_thin) with
    H_thin^T H_thin == H^T H and H_thin^T r_thin == H^T r, the contracts
    the EKF update reads. H_thin = chol(H^T H)^T, QR's R factor up to row
    signs for full column rank. An exactly zero column of H gets a unit
    diagonal entry in the factorization and a zero output row, so it
    carries no fake information."""
    Lam = H.T @ H
    b = H.T @ r
    zero_col = torch.diagonal(Lam) <= 0.0
    L, info = torch.linalg.cholesky_ex(Lam + torch.diag(zero_col.to(H.dtype)))
    L = torch.where(info == 0, L, torch.nan)
    r_thin = torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]
    H_thin = torch.where(zero_col[:, None], 0.0, L.T)
    return H_thin, torch.where(zero_col, 0.0, r_thin)


def masked_psd_solve(S, B, row_mask, reg=0.0):
    """Solve S X = B with the masked rows and columns of S replaced by the
    identity. S (..., m, m); B (..., m, n) or (..., m); row_mask (..., m).
    Masked rows of X are zero where the matching rows of B are."""
    m = S.shape[-1]
    mask = row_mask.to(S.dtype)
    outer = mask[..., :, None] * mask[..., None, :]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S * outer + (1.0 - outer) * eye
                                       + reg * eye)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    vector_rhs = B.dim() == S.dim() - 1
    X = torch.cholesky_solve(B[..., None] if vector_rhs else B, L)
    X = X * mask[..., :, None]
    return X[..., 0] if vector_rhs else X


def symmetrize(P):
    """(P + P^T)/2 — the reference re-symmetrizes after every covariance op."""
    return 0.5 * (P + P.transpose(-1, -2))


def top_k_indices(score, k: int):
    """Indices of the k largest entries of a 1-d score, ties lowest index
    first: ``jax.lax.top_k``'s order. A stable descending sort, because
    ``torch.topk`` gives no tie order (and the card's differs from the
    CPU's); the filter ranks 0/1 scores, so the tie order decides which
    features update and which promote."""
    return torch.sort(score, descending=True, stable=True).indices[:k]
