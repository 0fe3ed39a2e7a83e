"""Dense linear-algebra helpers for the filter, batched and masked.

Counterpart of ``orcvio_tpu/math/linalg.py`` (reference:
math_utils.hpp:287,315 nullspace projection, orcvio.cpp:486-494 chi-square
table): what the bench path uses. Padded (masked-out) rows are exact zero
rows, harmless through the Householder reflections and through
S = H P H^T + sigma^2 I.
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
        v = x.clone()
        v[..., j] = v[..., j] + sign * nx
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
