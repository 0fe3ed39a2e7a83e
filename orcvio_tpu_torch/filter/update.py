"""MSCKF measurement Jacobians, chi-square gating and the EKF update.

Counterpart of ``orcvio_tpu/filter/update.py`` (reference:
measurementJacobian_msckf orcvio.cpp:1071, featureJacobian_msckf :1171,
gatingTestFeature :1953, measurementUpdate_msckf :1654), on the bench path:
LARVIO Jacobians and the "direct" stacked update, whose covariance step
is kernel K4 (``ops/cov_update.py``).

Every feature contributes a fixed (2T)-row block; rows of invalid
observations and unselected features are exact zeros, which decouple in
S = H P H^T + sigma^2 I (identity rows, zero gain).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..math import linalg, se3, so3
from ..ops.cov_update import cov_update
from .augment import cam_poses, increment_state
from .state import LEG, FilterState
from .tracks import CompactTracks


class FeatureJacobians(NamedTuple):
    H: torch.Tensor  # (F, 2T, D) nullspace-projected stacked Jacobian
    r: torch.Tensor  # (F, 2T) projected residual
    dof: torch.Tensor  # (F,) 2 n_obs - 3
    usable: torch.Tensor  # (F,) enough rows for the nullspace trick
    H_raw: torch.Tensor  # (F, 2T, D) unprojected rows (for EKF promotion)
    Hf_raw: torch.Tensor  # (F, 2T, 3) feature-position block (world frame)
    r_raw: torch.Tensor  # (F, 2T)


def measurement_jacobians(cfg: FilterConfig, state: FilterState,
                          ct: CompactTracks, p_w):
    """Per-(feature, obs) H_x, H_e, H_f, r, LARVIO convention.
    Ref: measurementJacobian_msckf (orcvio.cpp:1071, :1148-1158).

    p_w: (F, 3) triangulated positions. Returns (H_x (F,T,2,6),
    H_e (F,T,2,6), H_f (F,T,2,3), r (F,T,2))."""
    R_c2w_all, t_c_w_all = cam_poses(state)
    R_b2w = state.clones.R[ct.slot]  # (F, T, 3, 3)
    t_b_w = state.clones.p[ct.slot]  # (F, T, 3)
    R_w2c = R_c2w_all[ct.slot].transpose(-1, -2)
    t_c_w = t_c_w_all[ct.slot]

    p_c = torch.einsum("ftij,ftj->fti", R_w2c, p_w[:, None, :] - t_c_w)
    r = ct.uv - p_c[..., :2] / p_c[..., 2:3]
    dz_dpc = se3.project_image_df(p_c)  # (F, T, 2, 3)
    p_bf_w = p_w[:, None, :] - t_b_w

    left_blk = R_w2c @ so3.hat(p_bf_w)
    H_x = dz_dpc @ torch.cat([left_blk, -R_w2c], dim=-1)
    dpc_dxe_l = (R_w2c @ so3.hat(p_bf_w) @ R_b2w
                 - (state.R_b2c @ so3.hat(state.t_c_b)))
    dpc_dxe = torch.cat([dpc_dxe_l, (-state.R_b2c).expand(dpc_dxe_l.shape)],
                        dim=-1)
    H_e = dz_dpc @ dpc_dxe
    H_f = dz_dpc @ R_w2c

    m = ct.mask[..., None]
    return (torch.where(m[..., None], H_x, 0.0),
            torch.where(m[..., None], H_e, 0.0),
            torch.where(m[..., None], H_f, 0.0),
            torch.where(m, r, 0.0))


def feature_jacobians(cfg: FilterConfig, state: FilterState, ct: CompactTracks,
                      p_w) -> FeatureJacobians:
    """Stack per-observation blocks into dense rows, then project H_f out.
    Ref: featureJacobian_msckf (orcvio.cpp:1171) + nullspace_project."""
    F, T = ct.mask.shape
    D = state.P.shape[0]
    H_x, H_e, H_f, r = measurement_jacobians(cfg, state, ct, p_w)

    # each observation's 2x6 clone block at columns LEG + 6 slot (a scatter
    # into zeros: the JAX package's one-hot contraction, value for value);
    # the extrinsic block at 15:21 never overlaps the clone columns
    dev = state.P.device
    cols = (LEG + 6 * ct.slot)[..., None, None] + torch.arange(6, device=dev)
    H = torch.zeros((F, T, 2, D), dtype=state.P.dtype, device=dev)
    H = H.scatter(-1, cols.expand(F, T, 2, 6), H_x)
    H[..., 15:21] = H_e

    Hrows = H.reshape(F, 2 * T, D)
    Hf_rows = H_f.reshape(F, 2 * T, 3)
    r_rows = r.reshape(F, 2 * T)
    usable = 2 * ct.n_obs > 3  # nullspace needs rows > cols
    Hp, rp = linalg.nullspace_project(Hf_rows, Hrows, r_rows)
    return FeatureJacobians(H=Hp, r=rp, dof=2 * ct.n_obs - 3, usable=usable,
                            H_raw=Hrows, Hf_raw=Hf_rows, r_raw=r_rows)


def gate_features(cfg: FilterConfig, state: FilterState, fj: FeatureJacobians,
                  chi2_table):
    """Chi-square gating. Ref: gatingTestFeature (orcvio.cpp:1953)."""
    sigma2 = cfg.observation_noise**2
    HP = torch.einsum("fmd,de->fme", fj.H, state.P)
    eye = torch.eye(fj.H.shape[1], dtype=state.P.dtype, device=state.P.device)
    S = torch.einsum("fme,fne->fmn", HP, fj.H) + sigma2 * eye
    gamma = linalg.chi2_gamma(S, fj.r)
    thresh = chi2_table[torch.clamp(fj.dof.long(), 0, chi2_table.shape[0] - 1)]
    return gamma < thresh


def apply_ekf_update(cfg: FilterConfig, state: FilterState, H, r):
    """Stacked EKF update in the "direct" form: no compression; zero rows
    decouple in S. Ref: measurementUpdate_msckf (orcvio.cpp:1654).

    K^T = S^{-1} H P by Cholesky; a failed factorization gives NaN, as the
    JAX package's does on the CPU (``cholesky_ex``: no host read of the
    error flag). The covariance step sym((I - K H) P) is kernel K4."""
    sigma2 = cfg.observation_noise**2
    P = state.P
    HP = H @ P
    eye = torch.eye(H.shape[0], dtype=P.dtype, device=P.device)
    S = HP @ H.T + sigma2 * eye
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.nan)
    K = torch.cholesky_solve(HP, L).T
    dx = K @ r
    state = increment_state(cfg, state, dx)
    return state.replace(P=cov_update(P, K, H, HP)), dx


def msckf_update(cfg: FilterConfig, state: FilterState, fj: FeatureJacobians,
                 use_mask):
    """Stacked point-feature EKF update over the first max_update_features
    selected rows. Ref: measurementUpdate_msckf (orcvio.cpp:1654)."""
    F, M, D = fj.H.shape
    K = min(cfg.max_update_features, F)
    top_idx = linalg.top_k_indices(use_mask.to(fj.H.dtype), K)
    top_use = use_mask[top_idx]
    Hm = torch.where(top_use[:, None, None], fj.H[top_idx], 0.0).reshape(K * M, D)
    rm = torch.where(top_use[:, None], fj.r[top_idx], 0.0).reshape(K * M)
    return apply_ekf_update(cfg, state, Hm, rm)
