"""Hybrid EKF-SLAM feature states, the 1-d inverse-depth path.

Counterpart of ``orcvio_tpu/filter/hybrid.py`` (reference:
measurementJacobian_ekf_1didp orcvio.cpp:1356, featureJacobian_ekf_new
:1481, measurementUpdate_hybrid :1766, rmLostFeaturesCov :3776,
updateFeatureCov_1didp :3611) at feature_idp_dim = 1: a fixed capacity of
E one-dof blocks (rho, the anchor bearing fixed) after the clone blocks.
Promotion writes covariance blocks in place at a slot held on the device,
removal zeroes them. Schmidt nuisance states are not ported (ROADMAP item
12); their capacity is 0 here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..math import linalg, se3, so3
from .augment import cam_poses
from .state import LEG, FilterState, set_block, set_rows, take, tree_where

B = 1  # the ported idp dimension


def ekf_base(cfg: FilterConfig) -> int:
    return LEG + 6 * cfg.sw_size


def idp_dim(cfg: FilterConfig) -> int:
    return cfg.feature_idp_dim


class EkfRows(NamedTuple):
    H: torch.Tensor  # (F, 2, D)
    r: torch.Tensor  # (F, 2)
    valid: torch.Tensor  # (F,)


def _rho(idp):
    return torch.where(torch.abs(idp[:, 2]) > 1e-8, idp[:, 2], 1e-8)


def feature_world_points(state: FilterState, cfg: FilterConfig = None):
    """World positions of in-state features from (idp, anchor clone)."""
    R_c2w, t_c_w = cam_poses(state)
    a = torch.clamp(state.features.anchor_slot.long(), 0,
                    state.clones.valid.shape[0] - 1)
    idp = state.features.idp
    rho = _rho(idp)
    p_ca = torch.stack([idp[:, 0] / rho, idp[:, 1] / rho, 1.0 / rho], dim=1)
    p_w = torch.einsum("fij,fj->fi", R_c2w[a], p_ca) + t_c_w[a]
    return p_w, p_ca


def _idp_jacobian(idp):
    """d p_ca / d idp, (F, 3, 3)."""
    rho = _rho(idp)
    one, zero = torch.ones_like(rho), torch.zeros_like(rho)
    J = torch.stack([
        torch.stack([one, zero, -idp[:, 0] / rho], -1),
        torch.stack([zero, one, -idp[:, 1] / rho], -1),
        torch.stack([zero, zero, -1.0 / rho], -1),
    ], dim=-2)
    return J / rho[:, None, None]


def _scatter_cols(H, cols, values):
    """H (F, R, D) + values (F, R, n) at columns cols (F, n) or (n,)."""
    F, R, _ = H.shape
    n = values.shape[-1]
    idx = cols.reshape(-1, 1, n).expand(F, R, n) if cols.dim() > 1 else \
        cols.expand(F, R, n)
    return H.scatter_add(-1, idx, values)


def ekf_feature_rows(cfg: FilterConfig, state: FilterState, cur_slot) -> EkfRows:
    """Per-frame 2-row blocks of tracked in-state features: the residual of
    the current observation against [current clone, anchor clone, rho].
    Ref: measurementJacobian_ekf_1didp (orcvio.cpp:1356)."""
    ft = state.features
    F = ft.fid.shape[0]
    D = state.P.shape[0]
    dtype, dev = state.P.dtype, state.P.device
    sw = cfg.sw_size

    a = torch.clamp(ft.anchor_slot.long(), 0, sw - 1)
    cur = cur_slot.reshape(1).long()
    uv_cur = ft.uv_valid.index_select(1, cur)[:, 0]
    valid = ft.in_state & ft.active & uv_cur & state.clones.valid[a]
    z = ft.uv.index_select(1, cur)[:, 0]  # (F, 2)

    R_c2w, t_c_w = cam_poses(state)
    p_w, _ = feature_world_points(state, cfg)
    R_w2ck = take(R_c2w, cur_slot).T
    t_ck_w = take(t_c_w, cur_slot)
    t_bk_w = take(state.clones.p, cur_slot)
    t_ba_w = state.clones.p[a]

    p_ck = torch.einsum("ij,fj->fi", R_w2ck, p_w - t_ck_w)
    zk = torch.where(torch.abs(p_ck[:, 2]) > 1e-6, p_ck[:, 2], 1e-6)
    r = z - p_ck[:, :2] / zk[:, None]

    J_k = se3.project_image_df(torch.cat([p_ck[:, :2], zk[:, None]], dim=1))
    J_p = torch.einsum("ij,fjk->fik", R_w2ck, R_c2w[a])
    H_f = (J_k @ J_p @ _idp_jacobian(ft.idp))[..., 2:3]  # rho column

    # clone blocks (left/larvio convention, orcvio.cpp:1327-1336)
    R_b = R_w2ck.expand(F, 3, 3)
    J_xa = torch.cat([-torch.einsum("ij,fjk->fik", R_w2ck, so3.hat(p_w - t_ba_w)),
                      R_b], dim=2)
    J_xk = torch.cat([torch.einsum("ij,fjk->fik", R_w2ck,
                                   so3.hat(p_w - t_bk_w[None])), -R_b], dim=2)
    H_a = J_k @ J_xa
    H_x = J_k @ J_xk
    valid = valid & (a != cur_slot)  # 1d: the anchor observation is unused

    ar6 = torch.arange(6, device=dev)
    H = torch.zeros((F, 2, D), dtype=dtype, device=dev)
    H = _scatter_cols(H, LEG + 6 * cur_slot.long() + ar6, H_x)
    H = _scatter_cols(H, (LEG + 6 * a)[:, None] + ar6, H_a)
    slot = torch.clamp(ft.state_slot.long(), 0, max(cfg.ekf_feature_cap - 1, 0))
    H = _scatter_cols(H, (ekf_base(cfg) + slot)[:, None], H_f)

    H = torch.where(valid[:, None, None], H, 0.0)
    r = torch.where(valid[:, None], r, 0.0)
    return EkfRows(H=H, r=r, valid=valid)


def split_projection(H_f, H, r):
    """Complete QR of a one-column H_f: split the rows into the
    feature-bearing row and the feature-free rest. Ref:
    featureJacobian_ekf_new (orcvio.cpp:1481).

    H_f (..., m, 1), H (..., m, D), r (..., m). Returns (H1 (..., 1, D),
    H2 (..., 1, 1), r1 (..., 1), Ho (..., m, D), ro (..., m)), Ho/ro the
    feature-free rows zero-padded to m. A one-column QR is one Householder
    reflection Q = Q^T = I - tau v v^T; it is built here as LAPACK's
    geqrf/orgqr build it (dlarfg: beta = -sign(x0) |x|, v0 = 1, tau = 0
    when x[1:] = 0), so the basis is the JAX package's CPU basis, not just
    one up to signs."""
    x = H_f[..., 0]
    x0 = x[..., 0]
    xn2 = torch.sum(x[..., 1:] * x[..., 1:], dim=-1)
    refl = xn2 > 0
    norm = torch.sqrt(x0 * x0 + xn2)
    beta = torch.where(x0 >= 0, -norm, norm)
    safe = torch.where(refl, beta, 1.0)
    tau = torch.where(refl, (beta - x0) / safe, 0.0)
    v = torch.cat([torch.ones_like(x[..., :1]),
                   x[..., 1:] / torch.where(refl, x0 - beta, 1.0)[..., None]],
                  dim=-1)

    def apply(M):  # Q^T M = M - tau v (v^T M)
        return M - (tau[..., None] * v)[..., :, None] * (v[..., None, :] @ M)

    Ht = apply(H)
    rt = apply(r[..., None])[..., 0]
    H2 = torch.where(refl, beta, x0)[..., None, None]
    m = H.shape[-2]
    keep = (torch.arange(m, device=H.device) < m - 1)[:, None]
    Ho = torch.where(keep, torch.roll(Ht, -1, dims=-2), 0.0)
    ro = torch.where(keep[:, 0], torch.roll(rt, -1, dims=-1), 0.0)
    return Ht[..., :1, :], H2, rt[..., :1], Ho, ro


def promote_features(cfg: FilterConfig, state: FilterState, cand_mask, H_raw,
                     Hf_idp_raw, r_raw, dx, row_ids):
    """Initialize up to 4 new EKF feature blocks after the frame's update.

    Ref: measurementUpdate_hybrid (orcvio.cpp:1824-1920):
    dx_new = H2^{-1}(r1 - H1 dx); P22 = HH P HH^T + sigma^2 (H2^T H2)^{-1};
    P21 = -HH P, with HH = H2^{-1} H1 and P the post-update covariance.
    cand_mask selects rows of the gathered H_raw (Kc, M, D); row_ids maps
    them to feature-table rows. Each of the 4 steps is computed and kept
    where it applies, as the JAX package's fori_loop does."""
    E = cfg.ekf_feature_cap
    P_MAX = min(4, E)
    D = state.P.shape[0]
    dtype, dev = state.P.dtype, state.P.device
    sigma2 = cfg.observation_noise**2
    base = ekf_base(cfg)

    cand_idx = linalg.top_k_indices(cand_mask.to(dtype), P_MAX)
    cand_ok = cand_mask[cand_idx]
    H1, H2, r1, _, _ = split_projection(Hf_idp_raw[cand_idx], H_raw[cand_idx],
                                        r_raw[cand_idx])
    true = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(P_MAX):
        st = state
        ft = st.features
        f = take(row_ids, cand_idx[i])
        # free slot: the lowest slot no in-state feature uses
        used = set_rows(torch.zeros(E, dtype=torch.bool, device=dev),
                        torch.where(ft.in_state,
                                    torch.clamp(ft.state_slot.long(), 0, E - 1), E),
                        true)
        slot = torch.argmin(used.to(torch.int8))
        do = cand_ok[i] & ~take(used, slot)

        h2 = H2[i, 0, 0] + 1e-10
        HH = H1[i] / h2  # (1, D)
        dx_new = (r1[i] - H1[i] @ dx) / h2  # (1,)
        P21 = -HH @ st.P  # (1, D)
        P22 = -P21 @ HH.T + sigma2 * (1.0 / h2) ** 2

        c0 = (base + slot).reshape(1)
        P = st.P.index_fill(0, c0, 0.0).index_fill(1, c0, 0.0)
        P = P.index_copy(0, c0, P21).index_copy(1, c0, P21.T)
        P = P.index_put((c0, c0), P22.reshape(1))
        P = linalg.symmetrize(P)

        didp = torch.cat([torch.zeros(2, dtype=dtype, device=dev), dx_new])
        fr = f.reshape(1).long()
        ft2 = ft.replace(
            in_state=ft.in_state.index_fill(0, fr, True),
            state_slot=ft.state_slot.index_copy(0, fr, slot.to(torch.int32)
                                                .reshape(1)),
            idp=ft.idp.index_add(0, fr, didp[None]),
        )
        state = tree_where(do, st.replace(P=P, features=ft2), st)
    return state


def remove_state_features(cfg: FilterConfig, state: FilterState, kill_mask):
    """Drop in-state features: zero their covariance blocks, free slots.
    Ref: rmLostFeaturesCov (orcvio.cpp:3776)."""
    E = cfg.ekf_feature_cap
    if E == 0:
        return state
    D = state.P.shape[0]
    dev = state.P.device
    base = ekf_base(cfg)
    ft = state.features
    kill = kill_mask & ft.in_state
    slot_killed = set_rows(
        torch.zeros(E, dtype=torch.bool, device=dev),
        torch.where(kill, torch.clamp(ft.state_slot.long(), 0, E - 1), E),
        torch.ones((), dtype=torch.bool, device=dev))
    colmask = torch.cat([
        torch.ones(base, dtype=torch.bool, device=dev), ~slot_killed,
        torch.ones(D - base - E, dtype=torch.bool, device=dev)])
    P = state.P * (colmask[:, None] & colmask[None, :])
    ft = ft.replace(in_state=ft.in_state & ~kill,
                    state_slot=torch.where(kill, -1, ft.state_slot))
    return state.replace(P=P, features=ft)


def _reanchor_map(delta, idp, Ra_f, pa_f, Rk, pk, R_b2c, t_c_b):
    """New-anchor inverse depth of one feature under the perturbation delta
    (21,) = [idp(3), old-anchor clone (3 + 3), new-anchor clone (3 + 3),
    extrinsic (3 + 3)], in the conventions of ekf_feature_rows; and the
    new-anchor depth."""
    dth_a, dp_a = delta[3:6], delta[6:9]
    dth_k, dp_k = delta[9:12], delta[12:15]
    dth_e, dt_e = delta[15:18], delta[18:21]
    idp_p = idp + delta[:3]
    Rbc = R_b2c @ so3.exp(-dth_e)
    tcb = t_c_b + dt_e
    Ra_p = so3.exp(dth_a) @ Ra_f
    Rk_p = so3.exp(dth_k) @ Rk
    # (1,) slices, not 0-d elements: a 0-d tensor with a Python float takes
    # a float64 tangent under torch.func.jacfwd
    rho = torch.where(torch.abs(idp_p[2:3]) > 1e-8, idp_p[2:3], 1e-8)
    p_ca = torch.cat([idp_p[:2] / rho, 1.0 / rho])
    p_w = Ra_p @ (Rbc.T @ p_ca + tcb) + pa_f + dp_a
    p_ck = Rbc @ (Rk_p.T @ (p_w - pk - dp_k) - tcb)
    z = torch.where(torch.abs(p_ck[2:3]) > 1e-6, p_ck[2:3], 1e-6)
    return torch.cat([p_ck[:2] / z, 1.0 / z]), p_ck[2]


def reanchor_features(cfg: FilterConfig, state: FilterState, prune_mask,
                      cur_slot):
    """Re-anchor in-state features whose anchor clone is being pruned to the
    current clone. Ref: the anchor-change branch of pruneImuStateBuffer
    (orcvio.cpp:2666-2725) + updateFeatureCov_1didp (:3611).

    The covariance row of each feature is transformed by the Jacobian of
    the re-parametrization with respect to [rho, old-anchor clone, new-anchor
    clone, extrinsic], by forward-mode autodiff at zero perturbation
    (torch.func.jacfwd under vmap; the JAX package's jax.jacfwd). Features
    whose re-anchoring is degenerate are left for the caller's removal
    pass."""
    E = cfg.ekf_feature_cap
    if E == 0:
        return state
    sw = cfg.sw_size
    D = state.P.shape[0]
    dtype, dev = state.P.dtype, state.P.device
    ft = state.features
    F = ft.fid.shape[0]
    base = ekf_base(cfg)

    in_window = (ft.anchor_slot >= 0) & (ft.anchor_slot < sw)
    a = torch.clamp(ft.anchor_slot.long(), 0, sw - 1)
    need = ft.in_state & in_window & prune_mask[a] & (a != cur_slot)
    if_any = torch.any(need)

    Rk = take(state.clones.R, cur_slot)
    pk = take(state.clones.p, cur_slot)
    zero = torch.zeros(21, dtype=dtype, device=dev)

    def value(idp, Ra_f, pa_f):
        return _reanchor_map(zero, idp, Ra_f, pa_f, Rk, pk, state.R_b2c,
                             state.t_c_b)

    def jac(idp, Ra_f, pa_f):
        return torch.func.jacfwd(lambda d: _reanchor_map(
            d, idp, Ra_f, pa_f, Rk, pk, state.R_b2c, state.t_c_b)[0])(zero)

    Ra, pa = state.clones.R[a], state.clones.p[a]
    idp_new, depth = torch.func.vmap(value)(ft.idp, Ra, pa)
    J = torch.func.vmap(jac)(ft.idp, Ra, pa)  # (F, 3, 21)
    ok = (need & (depth > 1e-3) & torch.all(torch.isfinite(idp_new), dim=1)
          & torch.all(torch.isfinite(J.reshape(F, -1)), dim=1))

    J = J[:, 2:3, :]  # rho row only
    slot = torch.clamp(ft.state_slot.long(), 0, E - 1)
    row0 = base + slot  # (F,)
    rows = torch.zeros((F, 1, D), dtype=dtype, device=dev)
    rows = _scatter_cols(rows, row0[:, None], J[:, :, 2:3])
    ar6 = torch.arange(6, device=dev)
    rows = _scatter_cols(rows, (LEG + 6 * a)[:, None] + ar6, J[:, :, 3:9])
    rows = _scatter_cols(rows, LEG + 6 * cur_slot.long() + ar6, J[:, :, 9:15])
    rows = _scatter_cols(rows, torch.arange(15, 21, device=dev), J[:, :, 15:21])
    ident = _scatter_cols(torch.zeros_like(rows), row0[:, None],
                          torch.ones((F, 1, 1), dtype=dtype, device=dev))
    rows = torch.where(ok[:, None, None], rows, ident)

    # P' rows/cols of the feature blocks: A = R P; block = A R^T
    flat = rows.reshape(F, D)
    A = flat @ state.P
    blk = A @ flat.T
    idx = torch.where(ft.in_state, row0, D)
    P = set_rows(state.P, idx, A)
    P = set_rows(P.T, idx, A).T
    P = set_block(P, idx, blk)
    P = linalg.symmetrize(P)

    ft2 = ft.replace(
        idp=torch.where(ok[:, None], idp_new, ft.idp),
        anchor_slot=torch.where(ok, cur_slot, ft.anchor_slot.long()).to(torch.int32),
    )
    return tree_where(if_any, state.replace(P=P, features=ft2), state)
