"""IMU mean and covariance propagation over a per-frame IMU slab.

Counterpart of ``orcvio_tpu/filter/propagation.py`` (reference:
batchImuProcessing orcvio.cpp:664, predictNewStateLARVIO :825,
calPhiClosedForm :3980), on the bench path: the LARVIO RK4 mean and the
closed-form left-convention transition. The slab runs batched over its S
samples: the orientation chain is a cumulative product of S small
rotations (a short loop), the per-sample Phi_k and Q_k are one batched op
set, and they fold by the same pairwise tree as the JAX package's
``_compose_transitions``. Masked samples are exact dt = 0 no-ops.
"""
from __future__ import annotations

import functools

import torch

from ..config.core import FilterConfig
from ..math import linalg, so3
from .state import BA, BG, LEG, POS, THETA, VEL, FilterState


@functools.lru_cache(maxsize=16)
def _constants(cfg: FilterConfig, dtype, device):
    """(gravity (3,), continuous noise covariance (12, 12)) on the device,
    made once: a copy from the host inside the frame loop would wait."""
    g = torch.as_tensor([0.0, 0.0, -cfg.gravity], dtype=dtype).to(device)
    Qc = torch.as_tensor(cfg.continuous_noise_cov(), dtype=dtype).to(device)
    return g, Qc


def gravity_vec(cfg: FilterConfig, dtype=torch.float32, device=None):
    return _constants(cfg, dtype, torch.device(device or "cpu"))[0]


def phi_closed_form_left(C_old, dt, gyro, acc, gyro_old, v_k, p_k, v_kp1,
                         p_kp1, g_w):
    """Closed-form Phi (22 x 22), left perturbation / LARVIO flavor, batched
    over a leading sample axis: C_old (S, 3, 3), dt (S,), vectors (S, 3),
    g_w (3,). Ref: calPhiClosedForm (orcvio.cpp:3980) with trivial IMU
    intrinsics."""
    S = dt.shape[0]
    dtype, dev = C_old.dtype, C_old.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    dt1 = dt[:, None]
    dt2 = dt[:, None, None]
    axis_angle = (dt1 * (gyro_old + gyro) / 2
                  + dt1 * dt1 * torch.linalg.cross(gyro_old, gyro) / 12)
    A = so3.hat(axis_angle)
    hat = so3.hat

    Phi = torch.eye(LEG, dtype=dtype, device=dev).repeat(S, 1, 1)
    Phi[:, THETA, BG] = -0.5 * C_old @ (2 * I3 + A) * dt2
    Phi[:, VEL, THETA] = -hat(v_kp1 - v_k - g_w * dt1)
    Phi[:, VEL, BG] = (
        hat(-p_kp1 + p_k + v_kp1 * dt1 - 0.5 * g_w * dt1 * dt1) @ C_old
        + hat(-0.5 * p_kp1 + 0.5 * p_k + 0.5 * v_kp1 * dt1
              - g_w * dt1 * dt1 / 6) @ C_old @ A)
    Phi[:, VEL, BA] = -0.5 * C_old @ (2 * I3 + A) * dt2
    Phi[:, POS, THETA] = -hat(p_kp1 - p_k - v_k * dt1 - 0.5 * g_w * dt1 * dt1)
    Phi[:, POS, VEL] = dt2 * I3
    Phi[:, POS, BG] = (-(dt2 ** 3) * hat(g_w) @ C_old / 6
                       + dt2 * hat(p_kp1 - p_k - g_w * dt1 * dt1 / 6)
                       @ C_old @ A / 4)
    Phi[:, POS, BA] = -C_old @ (3 * I3 + A) * (dt2 * dt2) / 6
    return Phi


def noise_input_matrix(C_old):
    """G (S, 22, 12), left/LARVIO convention. Ref: orcvio.cpp:773-795."""
    S = C_old.shape[0]
    G = torch.zeros((S, LEG, 12), dtype=C_old.dtype, device=C_old.device)
    I3 = torch.eye(3, dtype=C_old.dtype, device=C_old.device)
    G[:, THETA, 0:3] = -C_old
    G[:, VEL, 3:6] = -C_old
    G[:, BG, 6:9] = I3
    G[:, BA, 9:12] = I3
    return G


def _compose_transitions(Phi, Q):
    """Fold per-sample (Phi_k, Q_k) into (Phi_tot, Q_tot) by pairwise tree
    reduction: Phi_tot = Phi_{S-1} ... Phi_0, Q <- Phi_b Q_a Phi_b^T + Q_b."""
    n = Phi.shape[0]
    while n > 1:
        m = n // 2
        Pa, Qa = Phi[0: 2 * m: 2], Q[0: 2 * m: 2]
        Pb, Qb = Phi[1: 2 * m: 2], Q[1: 2 * m: 2]
        Pc = Pb @ Pa
        Qc = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
        if n % 2:
            Pc = torch.cat([Pc, Phi[-1:]], dim=0)
            Qc = torch.cat([Qc, Q[-1:]], dim=0)
        Phi, Q = Pc, Qc
        n = (n + 1) // 2
    return Phi[0], Q[0]


def _cumulative_product(exps):
    """cum[k] = exps[0] @ ... @ exps[k] by a log-depth doubling scan (the
    JAX package's associative_scan): log2(S) batched 3x3 matmul levels."""
    cum = exps
    S = exps.shape[0]
    shift = 1
    while shift < S:
        cum = torch.cat([cum[:shift], cum[:-shift] @ cum[shift:]], dim=0)
        shift *= 2
    return cum


def _imu_batch_transition_batched(cfg: FilterConfig, state: FilterState,
                                  imu_t, imu_gyro, imu_acc, imu_mask):
    """Whole-slab propagation: the mean, and the accumulated
    (Phi_tot, Q_tot). Returns (state, Phi_tot, Q_tot, last gyro, last acc).
    """
    dtype, dev = state.P.dtype, state.P.device
    S = imu_t.shape[0]
    g_w, Qc = _constants(cfg, dtype, dev)

    # forward-fill masked samples: masked rows become dt = 0 no-ops and the
    # next valid sample sees the last valid (gyro, acc) as its "old" pair
    idx = torch.arange(S, device=dev)
    fill = torch.cummax(torch.where(imu_mask, idx, -1), dim=0).values
    has = fill >= 0
    fc = torch.clamp(fill, 0, S - 1)
    t_eff = torch.where(has, imu_t[fc], state.t)
    g_eff = torch.where(has[:, None], imu_gyro[fc], state.last_gyro)
    a_eff = torch.where(has[:, None], imu_acc[fc], state.last_acc)
    t_prev = torch.cat([state.t[None], t_eff[:-1]])
    g_prev = torch.cat([state.last_gyro[None], g_eff[:-1]])
    dt = (t_eff - t_prev).to(dtype)

    gyro = g_eff - state.imu.bg
    acc = a_eff - state.imu.ba
    gyro_old = g_prev - state.imu.bg

    # mean: cumulative rotation product, then v/p prefix sums (LARVIO RK4)
    w_dt = dt[:, None] * gyro
    cum = _cumulative_product(so3.exp(w_dt))
    R0 = state.imu.R
    R_pre = torch.cat([R0[None], R0 @ cum[:-1]], dim=0)
    R_post = R0 @ cum
    R_mid = R_pre @ so3.exp(0.5 * w_dt)
    k1vd = torch.einsum("sij,sj->si", R_pre, acc) + g_w
    k2vd = torch.einsum("sij,sj->si", R_mid, acc) + g_w  # = k3vd
    k4vd = torch.einsum("sij,sj->si", R_post, acc) + g_w
    dv = dt[:, None] / 6.0 * (k1vd + 4.0 * k2vd + k4vd)
    dp_extra = dt[:, None] ** 2 / 6.0 * (k1vd + 2.0 * k2vd)

    zero = torch.zeros((1, 3), dtype=dtype, device=dev)
    v_cum = torch.cumsum(dv, dim=0)
    v_pre = state.imu.v + torch.cat([zero, v_cum[:-1]], dim=0)
    v_post = state.imu.v + v_cum
    dp = dt[:, None] * v_pre + dp_extra
    p_cum = torch.cumsum(dp, dim=0)
    p_pre = state.imu.p + torch.cat([zero, p_cum[:-1]], dim=0)
    p_post = state.imu.p + p_cum

    Phi = phi_closed_form_left(R_pre, dt, gyro, acc, gyro_old, v_pre, p_pre,
                               v_post, p_post, g_w)
    G = noise_input_matrix(R_pre)
    PhiG = Phi @ G
    Q = PhiG @ Qc @ PhiG.transpose(-1, -2) * dt[:, None, None]
    Phi_tot, Q_tot = _compose_transitions(Phi, Q)

    imu_new = state.imu.replace(R=R_post[-1], v=v_post[-1], p=p_post[-1])
    imu_old = state.imu.replace(R=R_pre[-1], v=v_pre[-1], p=p_pre[-1])
    fej_old = state.imu_fej_now if S == 1 else imu_old
    state2 = state.replace(t=t_eff[-1].to(state.t.dtype), imu=imu_new,
                           imu_old=imu_old, imu_fej_now=imu_new,
                           imu_fej_old=fej_old)
    return state2, Phi_tot, Q_tot, g_eff[-1], a_eff[-1]


def apply_leg_covariance(state: FilterState, Phi, Q) -> FilterState:
    """P <- T P T^T + Q with T = [[Phi, 0], [0, I]] (orcvio.cpp:797-816),
    then symmetrized."""
    P = state.P
    P_ll = Phi @ P[:LEG, :LEG] @ Phi.T + Q
    P_lr = Phi @ P[:LEG, LEG:]
    P = torch.cat([torch.cat([P_ll, P_lr], dim=1),
                   torch.cat([P_lr.T, P[LEG:, LEG:]], dim=1)], dim=0)
    return state.replace(P=linalg.symmetrize(P))


def imu_batch(cfg: FilterConfig, state: FilterState, imu_t, imu_gyro, imu_acc,
              imu_mask):
    """Propagate through a per-frame IMU slab. Ref: batchImuProcessing
    (orcvio.cpp:664). imu_t (S,), imu_gyro/imu_acc (S, 3), imu_mask (S,)."""
    state2, Phi, Q, g_last, a_last = _imu_batch_transition_batched(
        cfg, state, imu_t, imu_gyro, imu_acc, imu_mask)
    state2 = apply_leg_covariance(state2, Phi, Q)
    return state2.replace(last_gyro=g_last, last_acc=a_last)
