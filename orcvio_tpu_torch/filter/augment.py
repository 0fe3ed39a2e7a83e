"""Clone augmentation, sliding-window pruning and the state increment.

Counterpart of ``orcvio_tpu/filter/augment.py`` (reference:
stateAugmentation orcvio.cpp:930, findRedundantImuStates :2582,
pruneImuStateBuffer :2629, incrementState_IMUCam :4468). Clone slots are a
ring buffer: insert and remove are block writes and mask updates at an
index held on the device, never read back.
"""
from __future__ import annotations

import torch

from ..config.core import FilterConfig
from ..math import linalg, so3
from .state import LEG, FilterState, apply_imu_intrinsics_delta, put

_INT_MIN = torch.iinfo(torch.int32).min


def _slot_cols(slot, n: int = 6):
    """The n error-state columns of clone `slot` (0-d tensor), as a tensor."""
    return LEG + 6 * slot.long() + torch.arange(n, device=slot.device)


def state_augmentation(cfg: FilterConfig, state: FilterState) -> FilterState:
    """Insert the current IMU pose as a clone in the first free slot.
    Ref: stateAugmentation (orcvio.cpp:930).

    The slot's rows and columns become J P and its block J P J^T, with J
    picking the leg's [theta, p] blocks (orcvio.cpp:966-969)."""
    slot = torch.argmin(state.clones.valid.to(torch.int32))
    idx = _slot_cols(slot)
    P = state.P.index_fill(0, idx, 0.0).index_fill(1, idx, 0.0)
    JP = torch.cat([P[0:3], P[6:9]])  # J @ P: J is a 0/1 selection
    P = P.index_copy(0, idx, JP)
    P = P.index_copy(1, idx, JP.T)
    P = P.index_put((idx[:, None], idx[None, :]),
                    torch.cat([JP[:, 0:3], JP[:, 6:9]], dim=1))
    P = linalg.symmetrize(P)

    c = state.clones
    clones = c.replace(
        R=put(c.R, slot, state.imu.R),
        p=put(c.p, slot, state.imu.p),
        p_fej=put(c.p_fej, slot, state.imu_fej_now.p),
        t=put(c.t, slot, state.t),
        order=put(c.order, slot, state.next_order),
        valid=put(c.valid, slot, torch.ones((), dtype=torch.bool,
                                            device=P.device)),
    )
    return state.replace(clones=clones, P=P, next_order=state.next_order + 1)


def current_clone_slot(state: FilterState):
    """Slot of the most recently inserted clone (0-d tensor)."""
    return torch.argmax(torch.where(state.clones.valid, state.clones.order, -1))


def cam_poses(state: FilterState):
    """Camera pose (R_c2w, t_c_w) per clone slot from clones + extrinsics."""
    R_c2w = state.clones.R @ state.R_b2c.T
    t_c_w = state.clones.p + torch.einsum("sij,j->si", state.clones.R,
                                          state.t_c_b)
    return R_c2w, t_c_w


def select_prune_slots(cfg: FilterConfig, state: FilterState, tracking_rate,
                       rotation_threshold=0.2618, translation_threshold=0.4,
                       tracking_rate_threshold=0.5):
    """Up to 2 clone slots to prune, only when the window is full.
    Ref: findRedundantImuStates (orcvio.cpp:2582), the two-candidate rule
    of the JAX package. Returns (prune_mask (SW,), full)."""
    sw = cfg.sw_size
    full = torch.all(state.clones.valid)
    order = torch.where(state.clones.valid, state.clones.order, _INT_MIN)
    rank = torch.sort(order, stable=True).indices  # oldest first
    R_c2w, t_c_w = cam_poses(state)
    key, sel = rank[sw - 4: sw - 3], rank[sw - 3: sw - 1]  # key, candidates
    cand1, cand2 = sel.unbind()
    old1, old2 = rank[0:2].unbind()
    dist = torch.linalg.norm(t_c_w[sel] - t_c_w[key], dim=-1)
    ang = torch.linalg.norm(
        so3.log(R_c2w[sel].transpose(-1, -2) @ R_c2w[key]), dim=-1)
    red = ((ang < rotation_threshold) & (dist < translation_threshold)
           & (tracking_rate > tracking_rate_threshold))
    r1, r2 = red[0], red[1]
    slot_a = torch.where(r1, cand1, old1)
    slot_b = torch.where(r2, cand2, torch.where(r1, old1, old2))
    ar = torch.arange(sw, device=rank.device)
    mask = (ar == slot_a) | (ar == slot_b)
    return mask & full, full


def prune_clones(state: FilterState, prune_mask) -> FilterState:
    """Remove clones by mask: zero their P rows/cols, invalidate the slots,
    drop their observations. Ref: orcvio.cpp:2874-2955."""
    D = state.P.shape[0]
    sw = prune_mask.shape[0]
    colmask = torch.cat([
        torch.ones(LEG, dtype=torch.bool, device=prune_mask.device),
        ~torch.repeat_interleave(prune_mask, 6),
        torch.ones(D - LEG - 6 * sw, dtype=torch.bool, device=prune_mask.device),
    ])
    P = state.P * (colmask[:, None] & colmask[None, :])
    clones = state.clones.replace(
        valid=state.clones.valid & ~prune_mask,
        order=torch.where(prune_mask, -1, state.clones.order),
    )
    features = state.features.replace(
        uv_valid=state.features.uv_valid & ~prune_mask[None, :])
    return state.replace(P=P, clones=clones, features=features)


def increment_state(cfg: FilterConfig, state: FilterState, dx) -> FilterState:
    """Apply an error-state correction. Ref: incrementState_IMUCam
    (orcvio.cpp:4468). Left perturbation (or LARVIO): R <- exp(dtheta) R;
    right: R <- R exp(dtheta), for the IMU and the clones alike.

    The discard-large-update guard zeroes the mean increment when
    |dv| > 1 or |dp| > 1.5 and, as in the reference, leaves the caller's
    covariance update alone."""
    left = cfg.use_larvio or cfg.use_left_perturbation
    big = (torch.linalg.norm(dx[3:6]) > 1.0) | (torch.linalg.norm(dx[6:9]) > 1.5)
    dx = torch.where(big, torch.zeros_like(dx), dx)

    dR = so3.exp(dx[0:3])
    imu = state.imu.replace(
        R=dR @ state.imu.R if left else state.imu.R @ dR,
        v=state.imu.v + dx[3:6],
        p=state.imu.p + dx[6:9],
        bg=state.imu.bg + dx[9:12],
        ba=state.imu.ba + dx[12:15],
    )
    # extrinsic: R_imu_cam0 <- R_imu_cam0 exp(dtheta_e)^T (orcvio.cpp:4516)
    R_b2c = state.R_b2c @ so3.exp(dx[15:18]).T
    t_c_b = state.t_c_b + dx[18:21]
    td = state.td + dx[21]

    sw = state.clones.valid.shape[0]
    dclone = dx[LEG: LEG + 6 * sw].reshape(sw, 6)
    dRc = so3.exp(dclone[:, 0:3])
    Rc = dRc @ state.clones.R if left else state.clones.R @ dRc
    pc = state.clones.p + dclone[:, 3:6]
    valid = state.clones.valid
    clones = state.clones.replace(
        R=torch.where(valid[:, None, None], Rc, state.clones.R),
        p=torch.where(valid[:, None], pc, state.clones.p))
    state = state.replace(imu=imu, R_b2c=R_b2c, t_c_b=t_c_b, td=td,
                          clones=clones)

    # EKF feature blocks: idp += dx (measurementUpdate_hybrid, :1862-1874);
    # 1-d blocks move idp[:, 2] alone
    E = cfg.ekf_feature_cap
    if E:
        B = cfg.feature_idp_dim
        base = LEG + 6 * sw
        dfeat = dx[base: base + B * E].reshape(E, B)
        if B == 1:
            dfeat = torch.cat([torch.zeros((E, 2), dtype=dx.dtype,
                                           device=dx.device), dfeat], dim=1)
        ft = state.features
        slot = torch.clamp(ft.state_slot, 0, E - 1).long()
        delta = torch.where(ft.in_state[:, None], dfeat[slot], 0.0)
        state = state.replace(features=ft.replace(idp=ft.idp + delta))

    # IMU intrinsics: additive, then the matrices rebuilt (orcvio.cpp:
    # 4523-4533, updateImuMx)
    if cfg.calib_imu:
        ib = cfg.intrinsic_base
        Tg, As, Ma = apply_imu_intrinsics_delta(state.Tg, state.As, state.Ma,
                                                dx[ib: ib + 24])
        state = state.replace(Tg=Tg, As=As, Ma=Ma)
    return state
