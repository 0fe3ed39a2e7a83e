"""MSCKF measurement Jacobians, chi-square gating and the EKF update.

Counterpart of ``orcvio_tpu/filter/update.py`` (reference:
measurementJacobian_msckf orcvio.cpp:1071, featureJacobian_msckf :1171,
gatingTestFeature :1953, measurementUpdate_msckf :1654): the LARVIO and
the OrcVIO (left or right) Jacobians, FEJ, the extrinsic and td columns,
and the stacked update in the "direct", "qr", "chol" and "information"
forms, with or without the Joseph covariance form. The covariance step of
"direct", "qr" and "chol" is kernel K4 (``ops/cov_update.py``).

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
    """Per-(feature, obs) H_x, H_e, H_f, r. Ref: measurementJacobian_msckf
    (orcvio.cpp:1071; LARVIO :1148-1151, OrcVIO :1118-1146, extrinsic
    :1153-1158). With FEJ the feature's lever arm is taken from the clone's
    first-estimate position.

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
    p_ref = state.clones.p_fej[ct.slot] if cfg.if_fej else t_b_w
    p_bf_w = p_w[:, None, :] - p_ref

    if cfg.use_larvio:  # [R_w2c hat(p_bf_w) | -R_w2c]
        left_blk = R_w2c @ so3.hat(p_bf_w)
        H_x = dz_dpc @ torch.cat([left_blk, -R_w2c], dim=-1)
    else:  # odot of the point, through the camera-from-imu twist Jacobian
        dcam_dimu = se3.get_cam_wrt_imu_se3_jacobian(
            state.R_b2c, state.t_c_b, R_w2c, t_b_w, cfg.use_left_perturbation)
        if cfg.use_left_perturbation:
            cTw = se3.make_pose(R_w2c, -torch.einsum("ftij,ftj->fti", R_w2c,
                                                     t_c_w))
            base = cTw[..., :3, :] @ se3.odot(se3.to_homogeneous(p_w))[:, None]
        else:
            base = se3.odot(se3.to_homogeneous(p_c))[..., :3, :]
        H_x = -(dz_dpc @ (base @ dcam_dimu))
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
    # the extrinsic block at 15:21 and the td column 21 never overlap the
    # clone columns
    dev = state.P.device
    cols = (LEG + 6 * ct.slot)[..., None, None] + torch.arange(6, device=dev)
    H = torch.zeros((F, T, 2, D), dtype=state.P.dtype, device=dev)
    H = H.scatter(-1, cols.expand(F, T, 2, 6), H_x)
    td = (ct.uv_vel * ct.mask[..., None])[..., None] if cfg.estimate_td \
        else H[..., 21:22]
    H = torch.cat([H[..., :15], H_e, td, H[..., 22:]], dim=-1)

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


def information_update(cfg: FilterConfig, state: FilterState, Lam, b):
    """EKF update from the information pair (Lam, b) = (H^T H, H^T r), exact
    for R = sigma^2 I. With M = I + P Lam / sigma^2 (nonsingular for PSD P
    and Lam): P' = M^-1 P, dx = M^-1 P b / sigma^2. The one solve is an LU
    of M scaled by its diagonal (Jacobi), which stays finite where a
    slightly indefinite f32 P would break a Cholesky; a singular M gives
    NaN. Ref: the JAX package's information_update (update.py:152)."""
    D = state.P.shape[0]
    P = state.P
    sigma2 = cfg.observation_noise**2
    M = torch.eye(D, dtype=P.dtype, device=P.device) + P @ (Lam / sigma2)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(M)), min=1e-30))
    rhs = torch.cat([P @ (b / sigma2)[:, None], P], dim=1)
    sol, info = torch.linalg.solve_ex(M / (d[:, None] * d[None, :]),
                                      rhs / d[:, None])
    sol = torch.where(info == 0, sol, torch.nan) / d[:, None]
    dx = sol[:, 0]
    state = increment_state(cfg, state, dx)
    return state.replace(P=linalg.symmetrize(sol[:, 1:])), dx


def apply_ekf_update(cfg: FilterConfig, state: FilterState, H, r):
    """Stacked EKF update. Ref: measurementUpdate_msckf (orcvio.cpp:1654).

    Forms (``cfg.update_form``): "direct" (no compression; zero rows
    decouple in S), "qr" (thin QR, the reference's SPQR), "chol"
    (Gram-Cholesky) and "information" (``information_update``).
    K^T = S^{-1} H P by Cholesky; a failed factorization gives NaN, as the
    JAX package's does on the CPU (``cholesky_ex``: no host read of the
    error flag). The covariance step is sym((I - K H) P), kernel K4, or
    with ``joseph_form`` (I - K H) P (I - K H)^T + sigma^2 K K^T in plain
    algebra, as the JAX package computes it.

    With Schmidt nuisance states (the last 6 nuisance_cap columns, from
    nb = D - 6 nuisance_cap) the nuisance means and P_nn stay as they are:
    "information" runs as "qr" and ``joseph_form`` is ignored, as in the
    JAX package. The textbook form zeroes the nuisance rows of the gain
    for dx, and its covariance keeps P_nn and takes the one-sided update
    P_an - K_a (HP)_n into the cross block; the reference form
    (``schmidt_reference_semantics``) keeps the full gain and averages
    the two sides of the cross block. Since K = (S^{-1} H P)^T with S
    symmetric, K_n (HP)_a = (K_a (HP)_n)^T, so both covariances are
    sym(P - K HP) with P_nn kept: K4 with the full gain and its nb
    entry."""
    D = state.P.shape[0]
    schmidt = cfg.use_schmidt and cfg.nuisance_cap > 0
    if cfg.update_form == "information" and not schmidt:
        return information_update(cfg, state, H.T @ H, H.T @ r)
    if cfg.update_form in ("qr", "information"):
        H, r = linalg.qr_compress(H, r)
    elif cfg.update_form == "chol":
        H, r = linalg.chol_compress(H, r)
    elif cfg.update_form != "direct":
        raise ValueError(
            f"unknown update_form {cfg.update_form!r}: expected one of "
            "'direct', 'qr', 'information', 'chol'")
    sigma2 = cfg.observation_noise**2
    P = state.P
    HP = H @ P
    eye = torch.eye(H.shape[0], dtype=P.dtype, device=P.device)
    S = HP @ H.T + sigma2 * eye
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.nan)
    K = torch.cholesky_solve(HP, L).T
    dx = K @ r
    if not schmidt:
        state = increment_state(cfg, state, dx)
        if cfg.joseph_form:
            I_KH = torch.eye(D, dtype=P.dtype, device=P.device) - K @ H
            return state.replace(P=linalg.symmetrize(
                I_KH @ P @ I_KH.T + sigma2 * (K @ K.T))), dx
        return state.replace(P=cov_update(P, K, H, HP)), dx
    nb = D - 6 * cfg.nuisance_cap
    if not cfg.schmidt_reference_semantics:
        dx = torch.cat([dx[:nb], torch.zeros_like(dx[nb:])])
    state = increment_state(cfg, state, dx)
    return state.replace(P=cov_update(P, K, H, HP, nb=nb)), dx


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
