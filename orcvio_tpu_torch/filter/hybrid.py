"""Hybrid EKF-SLAM feature states: 1-d or 3-d inverse-depth blocks.

Counterpart of ``orcvio_tpu/filter/hybrid.py`` (reference:
measurementJacobian_ekf_3didp orcvio.cpp:1229, measurementJacobian_ekf_1didp
:1356, featureJacobian_ekf_new :1481, measurementUpdate_hybrid :1766,
rmLostFeaturesCov :3776, updateFeatureCov_3didp/_1didp :3457/:3611): a
fixed capacity of E blocks of B = feature_idp_dim dofs after the clone
blocks, (alpha, beta, rho) or rho alone with the anchor bearing fixed.
Promotion writes covariance blocks in place at a slot held on the device,
removal zeroes them. The Jacobians use the left/LARVIO clone convention
whatever the flags, as the JAX package's and the reference's hybrid paths
do. With Schmidt nuisance states (use_schmidt, nuisance_cap) a pruned
clone that still anchors EKF features moves to a nuisance slot
(``schmidt_demote``, the Schmidt branch of pruneImuStateBuffer,
orcvio.cpp:2874-2955) and its features keep their anchor there (extended
anchor slot sw_size + nuisance slot); a nuisance slot no feature anchors
on is freed (``retire_nuisance``, rmUselessNuisanceState :4421).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..math import linalg, se3, so3
from ..tree import tree_where
from .augment import cam_poses
from .state import LEG, FilterState, put, set_block, set_rows, take


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


def nui_base(cfg: FilterConfig) -> int:
    """First error-state column of the nuisance blocks: after the EKF
    features and the IMU intrinsics."""
    return (ekf_base(cfg) + idp_dim(cfg) * cfg.ekf_feature_cap
            + cfg.intrinsic_dim)


def extended_cam_poses(cfg: FilterConfig, state: FilterState):
    """Camera poses of the clones, then of the nuisance clones: indexed by
    extended anchor slots (slot sw_size + n is nuisance slot n)."""
    R_c2w, t_c_w = cam_poses(state)
    if cfg.nuisance_cap == 0:
        return R_c2w, t_c_w
    R_n = state.nui.R @ state.R_b2c.T
    t_n = state.nui.p + torch.einsum("nij,j->ni", state.nui.R, state.t_c_b)
    return torch.cat([R_c2w, R_n]), torch.cat([t_c_w, t_n])


def feature_world_points(state: FilterState, cfg: FilterConfig):
    """World positions of in-state features from (idp, anchor clone), the
    anchor a nuisance clone where it was demoted."""
    R_c2w, t_c_w = extended_cam_poses(cfg, state)
    a = torch.clamp(state.features.anchor_slot.long(), 0, R_c2w.shape[0] - 1)
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
    the current observation against [current clone, anchor clone, idp].
    Ref: measurementJacobian_ekf_3didp (orcvio.cpp:1229) and _1didp
    (:1356). A 3-d feature observed in its anchor frame observes (alpha,
    beta) directly (:1305); a 1-d one does not use that observation
    (:1434). A demoted anchor's columns are its nuisance block's."""
    ft = state.features
    F = ft.fid.shape[0]
    D = state.P.shape[0]
    dtype, dev = state.P.dtype, state.P.device
    sw = cfg.sw_size
    B = idp_dim(cfg)

    N = cfg.nuisance_cap
    anchor_valid = state.clones.valid
    imu_p = state.clones.p
    if N:
        anchor_valid = torch.cat([anchor_valid, state.nui.valid])
        imu_p = torch.cat([imu_p, state.nui.p])
    a = torch.clamp(ft.anchor_slot.long(), 0, sw + N - 1)
    cur = cur_slot.reshape(1).long()
    uv_cur = ft.uv_valid.index_select(1, cur)[:, 0]
    valid = ft.in_state & ft.active & uv_cur & anchor_valid[a]
    z = ft.uv.index_select(1, cur)[:, 0]  # (F, 2)

    R_c2w, t_c_w = extended_cam_poses(cfg, state)
    p_w, _ = feature_world_points(state, cfg)
    R_w2ck = take(R_c2w, cur_slot).T
    t_ck_w = take(t_c_w, cur_slot)
    t_bk_w = take(state.clones.p, cur_slot)
    t_ba_w = imu_p[a]

    p_ck = torch.einsum("ij,fj->fi", R_w2ck, p_w - t_ck_w)
    zk = torch.where(torch.abs(p_ck[:, 2]) > 1e-6, p_ck[:, 2], 1e-6)
    r = z - p_ck[:, :2] / zk[:, None]

    J_k = se3.project_image_df(torch.cat([p_ck[:, :2], zk[:, None]], dim=1))
    J_p = torch.einsum("ij,fjk->fik", R_w2ck, R_c2w[a])
    H_f = J_k @ J_p @ _idp_jacobian(ft.idp)
    if B == 1:
        H_f = H_f[..., 2:3]  # rho column (orcvio.cpp:1474)

    # clone blocks (left/larvio convention, orcvio.cpp:1327-1336)
    R_b = R_w2ck.expand(F, 3, 3)
    J_xa = torch.cat([-torch.einsum("ij,fjk->fik", R_w2ck, so3.hat(p_w - t_ba_w)),
                      R_b], dim=2)
    J_xk = torch.cat([torch.einsum("ij,fjk->fik", R_w2ck,
                                   so3.hat(p_w - t_bk_w[None])), -R_b], dim=2)
    H_a = J_k @ J_xa
    H_x = J_k @ J_xk
    at_anchor = a == cur_slot
    if B == 3:
        H_f_anchor = torch.eye(2, 3, dtype=dtype, device=dev).expand(F, 2, 3)
        at = at_anchor[:, None, None]
        H_f = torch.where(at, H_f_anchor, H_f)
        H_a = torch.where(at, 0.0, H_a)
        H_x = torch.where(at, 0.0, H_x)
        r = torch.where(at_anchor[:, None], z - ft.idp[:, :2], r)
    else:
        valid = valid & ~at_anchor

    ar6 = torch.arange(6, device=dev)
    H = torch.zeros((F, 2, D), dtype=dtype, device=dev)
    H = _scatter_cols(H, LEG + 6 * cur_slot.long() + ar6, H_x)
    # anchor columns: the clone block, or the nuisance block of a demoted
    # anchor
    a_col0 = torch.where(a < sw, LEG + 6 * a, nui_base(cfg) + 6 * (a - sw))
    H = _scatter_cols(H, a_col0[:, None] + ar6, H_a)
    slot = torch.clamp(ft.state_slot.long(), 0, max(cfg.ekf_feature_cap - 1, 0))
    H = _scatter_cols(H, (ekf_base(cfg) + B * slot)[:, None]
                      + torch.arange(B, device=dev), H_f)

    H = torch.where(valid[:, None, None], H, 0.0)
    r = torch.where(valid[:, None], r, 0.0)
    return EkfRows(H=H, r=r, valid=valid)


def split_projection(H_f, H, r):
    """Complete QR of H_f (..., m, k): split the rows into the k
    feature-bearing rows and the feature-free rest. Ref:
    featureJacobian_ekf_new (orcvio.cpp:1481).

    H (..., m, D), r (..., m). Returns (H1 (..., k, D), H2 (..., k, k)
    upper triangular, r1 (..., k), Ho (..., m, D), ro (..., m)), Ho/ro the
    feature-free rows zero-padded to m. Q is k Householder reflections
    built as LAPACK's geqrf/orgqr build them (dlarfg: beta = -sign(x0) |x|,
    v0 = 1, tau = 0 when the column below the diagonal is zero), so the
    basis is the JAX package's CPU basis, not just one up to signs."""
    m, k = H_f.shape[-2:]
    rows = torch.arange(m, device=H.device)
    A, Ht, rt = H_f, H, r[..., None]
    R_rows = []
    for j in range(k):
        x0 = A[..., j, j]
        tail = torch.where(rows > j, A[..., :, j], 0.0)
        xn2 = torch.sum(tail * tail, dim=-1)
        refl = xn2 > 0
        norm = torch.sqrt(x0 * x0 + xn2)
        beta = torch.where(x0 >= 0, -norm, norm)
        tau = torch.where(refl, (beta - x0) / torch.where(refl, beta, 1.0), 0.0)
        v = torch.where(rows == j, 1.0,
                        tail / torch.where(refl, x0 - beta, 1.0)[..., None])

        def apply(M):  # (I - tau v v^T) M
            return M - (tau[..., None] * v)[..., :, None] * (v[..., None, :] @ M)

        A, Ht, rt = apply(A), apply(Ht), apply(rt)
        # row j of R: the reflected row, beta on the diagonal, zeros left
        col = torch.arange(k, device=H.device)
        R_rows.append(torch.where(col < j, 0.0, torch.where(
            col == j, torch.where(refl, beta, x0)[..., None], A[..., j, :])))
    rt = rt[..., 0]
    keep = (rows < m - k)[:, None]
    Ho = torch.where(keep, torch.roll(Ht, -k, dims=-2), 0.0)
    ro = torch.where(keep[:, 0], torch.roll(rt, -k, dims=-1), 0.0)
    return Ht[..., :k, :], torch.stack(R_rows, dim=-2), rt[..., :k], Ho, ro


def _upper_solve(U, X):
    """U^-1 X for upper-triangular U (..., B, B); a 1x1 U divides."""
    if U.shape[-1] == 1:
        return X / U
    return torch.linalg.solve_triangular(U, X, upper=True)


def promote_features(cfg: FilterConfig, state: FilterState, cand_mask, H_raw,
                     Hf_idp_raw, r_raw, dx, row_ids):
    """Initialize up to 4 new EKF feature blocks after the frame's update.

    Ref: measurementUpdate_hybrid (orcvio.cpp:1824-1920):
    dx_new = H2^{-1}(r1 - H1 dx); P22 = HH P HH^T + sigma^2 (H2^T H2)^{-1};
    P21 = -HH P, with HH = H2^{-1} H1 and P the post-update covariance.
    cand_mask selects rows of the gathered H_raw (Kc, M, D); Hf_idp_raw
    (Kc, M, B) is the idp block; row_ids maps rows to feature-table rows.
    Each of the 4 steps is computed and kept where it applies, as the JAX
    package's fori_loop does."""
    E = cfg.ekf_feature_cap
    B = idp_dim(cfg)
    P_MAX = min(4, E)
    dtype, dev = state.P.dtype, state.P.device
    sigma2 = cfg.observation_noise**2
    base = ekf_base(cfg)
    eye = torch.eye(B, dtype=dtype, device=dev)
    arB = torch.arange(B, device=dev)

    cand_idx = linalg.top_k_indices(cand_mask.to(dtype), P_MAX)
    cand_ok = cand_mask[cand_idx]
    H1, H2, r1, _, _ = split_projection(Hf_idp_raw[cand_idx], H_raw[cand_idx],
                                        r_raw[cand_idx])
    H2r = H2 + 1e-10 * eye
    HH = _upper_solve(H2r, H1)  # (P_MAX, B, D)
    H2i = _upper_solve(H2r, eye.expand(P_MAX, B, B))
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

        dx_new = _upper_solve(H2r[i], (r1[i] - H1[i] @ dx)[:, None])[:, 0]
        P21 = -HH[i] @ st.P  # (B, D)
        P22 = -P21 @ HH[i].T + sigma2 * (H2i[i] @ H2i[i].T)

        c0 = base + B * slot + arB
        P = st.P.index_fill(0, c0, 0.0).index_fill(1, c0, 0.0)
        P = P.index_copy(0, c0, P21).index_copy(1, c0, P21.T)
        P = P.index_put((c0[:, None], c0[None, :]), P22)
        P = linalg.symmetrize(P)

        didp = dx_new if B == 3 else torch.cat(
            [torch.zeros(2, dtype=dtype, device=dev), dx_new])
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
    B = idp_dim(cfg)
    colmask = torch.cat([
        torch.ones(base, dtype=torch.bool, device=dev),
        ~torch.repeat_interleave(slot_killed, B),
        torch.ones(D - base - B * E, dtype=torch.bool, device=dev)])
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
    (orcvio.cpp:2666-2725) + updateFeatureCov_3didp/_1didp (:3457/:3611).

    The covariance rows of each feature are transformed by the Jacobian of
    the re-parametrization with respect to [idp, old-anchor clone, new-anchor
    clone, extrinsic], by forward-mode autodiff at zero perturbation
    (torch.func.jacfwd under vmap; the JAX package's jax.jacfwd). Features
    whose re-anchoring is degenerate are left for the caller's removal
    pass."""
    E = cfg.ekf_feature_cap
    if E == 0:
        return state
    B = idp_dim(cfg)
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

    if B == 1:
        J = J[:, 2:3, :]  # rho row only
        J_idp = J[:, :, 2:3]  # d rho_new / d rho_old
    else:
        J_idp = J[:, :, :3]
    slot = torch.clamp(ft.state_slot.long(), 0, E - 1)
    own = (base + B * slot)[:, None] + torch.arange(B, device=dev)  # (F, B)
    rows = torch.zeros((F, B, D), dtype=dtype, device=dev)
    rows = _scatter_cols(rows, own, J_idp)
    ar6 = torch.arange(6, device=dev)
    rows = _scatter_cols(rows, (LEG + 6 * a)[:, None] + ar6, J[:, :, 3:9])
    rows = _scatter_cols(rows, LEG + 6 * cur_slot.long() + ar6, J[:, :, 9:15])
    rows = _scatter_cols(rows, torch.arange(15, 21, device=dev), J[:, :, 15:21])
    # the rows of in-state features that keep their anchor: the JAX
    # package's, which set every (row, own column) pair to 1 (its broadcast
    # .at[f, r, cols_own].set(1.0)), so at B = 3 they are rows of ones, not
    # the identity, and the block of each such feature becomes its sum on
    # any frame where another feature re-anchors. Kept for parity (ROADMAP
    # section 3, item 16); at B = 1 it is the identity.
    ident = _scatter_cols(torch.zeros_like(rows), own,
                          torch.ones((F, B, B), dtype=dtype, device=dev))
    rows = torch.where(ok[:, None, None], rows, ident)

    # P' rows/cols of the feature blocks: A = R P; block = A R^T
    flat = rows.reshape(F * B, D)
    A = flat @ state.P
    blk = A @ flat.T
    idx = torch.where(ft.in_state[:, None], own, D).reshape(-1)
    P = set_rows(state.P, idx, A)
    P = set_rows(P.T, idx, A).T
    P = set_block(P, idx, blk)
    P = linalg.symmetrize(P)

    ft2 = ft.replace(
        idp=torch.where(ok[:, None], idp_new, ft.idp),
        anchor_slot=torch.where(ok, cur_slot, ft.anchor_slot.long()).to(torch.int32),
    )
    return tree_where(if_any, state.replace(P=P, features=ft2), state)


def schmidt_demote(cfg: FilterConfig, state: FilterState, prune_mask):
    """Move each pruned clone that anchors an in-state EKF feature into the
    first free nuisance slot, in slot order: its covariance rows, columns
    and block copied to the nuisance block (the stale cross block between
    the two zeroed), its pose copied, its features' anchor remapped to
    sw_size + the nuisance slot. Ref: the Schmidt branch of
    pruneImuStateBuffer (orcvio.cpp:2874-2955). Where no slot is free the
    clone is left to the caller's removal pass."""
    N = cfg.nuisance_cap
    if N == 0 or not cfg.use_schmidt:
        return state
    sw = cfg.sw_size
    dev = state.P.device
    nb = nui_base(cfg)
    ar6 = torch.arange(6, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    for slot in range(sw):
        st = state
        ft = st.features
        has_anchor = torch.any(ft.in_state & (ft.anchor_slot == slot))
        free = ~st.nui.valid
        n_slot = torch.argmax(free.to(torch.int8))
        do = (prune_mask[slot] & has_anchor & st.clones.valid[slot]
              & take(free, n_slot))

        c = LEG + 6 * slot
        n = nb + 6 * n_slot + ar6
        P = st.P.index_copy(0, n, st.P[c: c + 6])
        P = P.index_copy(1, n, P[:, c: c + 6])
        P = P.index_put((n[:, None], n[None, :]), st.P[c: c + 6, c: c + 6])
        zero = P.new_zeros((6, 6))
        P = P.index_put((n[:, None], (c + ar6)[None, :]), zero)
        P = P.index_put(((c + ar6)[:, None], n[None, :]), zero)

        nui = st.nui.replace(R=put(st.nui.R, n_slot, st.clones.R[slot]),
                             p=put(st.nui.p, n_slot, st.clones.p[slot]),
                             t=put(st.nui.t, n_slot, st.clones.t[slot]),
                             valid=put(st.nui.valid, n_slot, true))
        remap = ft.in_state & (ft.anchor_slot == slot)
        ft2 = ft.replace(anchor_slot=torch.where(
            remap, sw + n_slot, ft.anchor_slot.long()).to(torch.int32))
        state = tree_where(do, st.replace(P=P, nui=nui, features=ft2), st)
    return state


def retire_nuisance(cfg: FilterConfig, state: FilterState):
    """Free the nuisance slots no in-state feature anchors on: zero their
    covariance blocks and invalidate them. Ref: rmUselessNuisanceState
    (orcvio.cpp:4421)."""
    N = cfg.nuisance_cap
    if N == 0:
        return state
    sw = cfg.sw_size
    D = state.P.shape[0]
    dev = state.P.device
    ft = state.features
    anchored = set_rows(
        torch.zeros(N, dtype=torch.bool, device=dev),
        torch.where(ft.in_state & (ft.anchor_slot >= sw),
                    torch.clamp(ft.anchor_slot.long() - sw, 0, N - 1), N),
        torch.ones((), dtype=torch.bool, device=dev))
    kill = state.nui.valid & ~anchored
    # the nuisance blocks are the last 6 N columns
    colmask = torch.cat([torch.ones(D - 6 * N, dtype=torch.bool, device=dev),
                         ~torch.repeat_interleave(kill, 6)])
    P = state.P * (colmask[:, None] & colmask[None, :])
    return state.replace(P=P, nui=state.nui.replace(
        valid=state.nui.valid & ~kill))
