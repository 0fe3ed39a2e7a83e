"""IMU mean and covariance propagation over a per-frame IMU slab.

Counterpart of ``orcvio_tpu/filter/propagation.py`` (reference:
batchImuProcessing orcvio.cpp:664, predictNewStateLARVIO :825,
predictNewStateOrcVIO :899, calPhiEulerMethod :3952, calPhiClosedForm
:3980): the LARVIO RK4 mean or the SE(3) closed-form mean, and the
transition of the flags (closed form, left or right, or first-order
Euler). The slab runs batched over its S samples: the orientation chain
is a cumulative product of S small rotations (a short loop), the
per-sample Phi_k and Q_k are one batched op set, and they fold by the same
pairwise tree as the JAX package's ``_compose_transitions``. With
``calib_imu`` the measurements are corrected, acc = Ma (a_m - ba),
gyro = Tg (w_m - As acc - bg) (processModel, orcvio.cpp:732-746), the
[theta v p] x [bg ba intrinsics] columns are the forward-mode derivative
(``torch.func.jacfwd``) of each sample's exact mean step at zero
perturbation, batched over the samples, and the 24 intrinsic columns S
fold in the same tree as S <- Phi_b S_a + S_b. Masked samples are exact
dt = 0 no-ops.
"""
from __future__ import annotations

import functools

import torch

from ..config.core import FilterConfig
from ..math import linalg, so3
from .state import (BA, BG, LEG, POS, THETA, VEL, FilterState, ImuState,
                    apply_imu_intrinsics_delta)

# 3x3 block indices of the error-state slices, the keys of _assemble's
# blocks (slices themselves hash only from Python 3.12 on).
_TH, _V, _P, _BG, _BA = (s.start // 3 for s in (THETA, VEL, POS, BG, BA))


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
    return _assemble(S, {
        (_TH, _BG): -0.5 * C_old @ (2 * I3 + A) * dt2,
        (_V, _TH): -hat(v_kp1 - v_k - g_w * dt1),
        (_V, _BG): (
            hat(-p_kp1 + p_k + v_kp1 * dt1 - 0.5 * g_w * dt1 * dt1) @ C_old
            + hat(-0.5 * p_kp1 + 0.5 * p_k + 0.5 * v_kp1 * dt1
                  - g_w * dt1 * dt1 / 6) @ C_old @ A),
        (_V, _BA): -0.5 * C_old @ (2 * I3 + A) * dt2,
        (_P, _TH): -hat(p_kp1 - p_k - v_k * dt1 - 0.5 * g_w * dt1 * dt1),
        (_P, _V): dt2 * I3,
        (_P, _BG): (-(dt2 ** 3) * hat(g_w) @ C_old / 6
                    + dt2 * hat(p_kp1 - p_k - g_w * dt1 * dt1 / 6)
                    @ C_old @ A / 4),
        (_P, _BA): -C_old @ (3 * I3 + A) * (dt2 * dt2) / 6}, LEG, LEG, I3)


def _assemble(S, blocks, rows, cols, I3, eye=True):
    """(S, rows, cols) from 3x3 blocks over the first 15 states, keyed by
    (row block, col block) index: each given block where it is given,
    elsewhere the identity (with eye) or zeros. Built out of place (no
    writes into a fresh tensor), so that it batches under
    torch.func.vmap."""
    nc = min(cols, 15) // 3
    z = torch.zeros_like(I3)

    def block(i, j):
        b = blocks.get((i, j))
        if b is None:
            b = I3 if eye and i == j else z
        return b.expand(S, 3, 3)

    top = torch.cat([torch.cat([block(i, j) for j in range(nc)], -1)
                     for i in range(5)], -2)
    z0 = z[0, 0]
    tail = (torch.eye if eye else torch.zeros)(
        rows - 15, cols - 3 * nc, dtype=I3.dtype, device=I3.device)
    low = torch.cat([z0.expand(rows - 15, 3 * nc), tail], -1)
    top = torch.cat([top, z0.expand(S, 15, cols - 3 * nc)], -1)
    return torch.cat([top, low.expand(S, rows - 15, cols)], -2)


def _closed_form_increments(R, gyro, acc, dt, g_w):
    """The SE(3) closed form's velocity and position increments over one
    constant sample from orientation R, batched over leading dims:
    (g dt + R Jl(dt w) a dt, g dt^2/2 + R Hl(dt w) a dt^2)."""
    dt1 = dt[..., None]
    w_dt = dt1 * gyro
    Jl_a = torch.einsum("...ij,...j->...i", so3.left_jacobian(w_dt), acc)
    Hl_a = torch.einsum("...ij,...j->...i", so3.Hl(w_dt), acc)
    dv = g_w * dt1 + torch.einsum("...ij,...j->...i", R, Jl_a) * dt1
    dp = (g_w * (dt1 * dt1) * 0.5
          + torch.einsum("...ij,...j->...i", R, Hl_a) * (dt1 * dt1))
    return dv, dp


def propagate_mean_closed_form(imu: ImuState, gyro, acc, dt, g_w) -> ImuState:
    """SE(3) closed-form mean over one constant sample, batched over the
    leading dims of gyro, acc (..., 3) and dt (...). Ref:
    predictNewStateOrcVIO (orcvio.cpp:899).

    p' = p + v dt + g dt^2/2 + R Hl(dt w) a dt^2
    v' = v + g dt + R Jl(dt w) a dt
    R' = R exp(dt w)
    """
    dv, dp = _closed_form_increments(imu.R, gyro, acc, dt, g_w)
    return imu.replace(R=imu.R @ so3.exp(dt[..., None] * gyro), v=imu.v + dv,
                       p=imu.p + dt[..., None] * imu.v + dp)


def _rk4_increments(R_pre, R_post, gyro, acc, dt, g_w):
    """LARVIO's RK4 velocity and position increments over one constant
    sample from orientation R_pre to R_post = R_pre exp(dt w), batched over
    a leading sample axis: (dv, dp - v dt). Ref: predictNewStateLARVIO
    (orcvio.cpp:825), on rotation matrices with the exact half- and
    full-step attitudes (k2 = k3)."""
    w_dt = dt[:, None] * gyro
    R_mid = R_pre @ so3.exp(0.5 * w_dt)
    k1vd = torch.einsum("sij,sj->si", R_pre, acc) + g_w
    k2vd = torch.einsum("sij,sj->si", R_mid, acc) + g_w  # = k3vd
    k4vd = torch.einsum("sij,sj->si", R_post, acc) + g_w
    dv = dt[:, None] / 6.0 * (k1vd + 4.0 * k2vd + k4vd)
    dp_extra = dt[:, None] ** 2 / 6.0 * (k1vd + 2.0 * k2vd)
    return dv, dp_extra


def propagate_mean_rk4(imu: ImuState, gyro, acc, dt, g_w) -> ImuState:
    """LARVIO's RK4 mean over one constant sample: gyro, acc (3,), dt a
    number or a 0-d tensor. Ref: predictNewStateLARVIO (orcvio.cpp:825),
    on rotation matrices with the exact half- and full-step attitudes.

    R' = R exp(dt w), v' = v + dv, p' = p + v dt + dp (_rk4_increments)
    """
    dt = torch.as_tensor(dt, dtype=imu.R.dtype, device=imu.R.device)
    R = imu.R @ so3.exp(dt * gyro)
    dv, dp = _rk4_increments(imu.R[None], R[None], gyro[None], acc[None],
                             dt.reshape(1), g_w)
    return imu.replace(R=R, v=imu.v + dv[0], p=imu.p + dt * imu.v + dp[0])


def _mean_increments(cfg: FilterConfig, R_pre, R_post, gyro, acc, dt, g_w):
    """(dv, dp - v dt) of the configured mean: RK4 or the SE(3) closed
    form."""
    if cfg.use_larvio:
        return _rk4_increments(R_pre, R_post, gyro, acc, dt, g_w)
    return _closed_form_increments(R_pre, gyro, acc, dt, g_w)


def phi_euler(R_new, gyro, acc, dt, use_left_perturbation: bool):
    """First-order Phi (S, 22, 22) from the post-propagation orientation
    R_new (S, 3, 3), as the reference calls it after the mean. Ref:
    calPhiEulerMethod (orcvio.cpp:3952)."""
    S = dt.shape[0]
    dtype, dev = R_new.dtype, R_new.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    dt2 = dt[:, None, None]
    if use_left_perturbation:
        blocks = {(_TH, _BG): -dt2 * R_new,
                  (_V, _TH): -dt2 * so3.hat(torch.einsum(
                      "sij,sj->si", R_new, acc))}
    else:
        blocks = {(_TH, _TH): I3 - dt2 * so3.hat(gyro),
                  (_TH, _BG): -dt2 * I3,
                  (_V, _TH): -dt2 * R_new @ so3.hat(acc)}
    blocks[_V, _BA] = -dt2 * R_new
    blocks[_P, _V] = dt2 * I3
    return _assemble(S, blocks, LEG, LEG, I3)


def phi_closed_form_right(C_old, dt, gyro, acc):
    """Closed-form Phi (S, 22, 22), right perturbation (R' = R exp(dtheta)),
    batched over samples: C_old (S, 3, 3), dt (S,), gyro, acc (S, 3). Ref:
    orcvio.cpp:4308-4370, with the JAX package's correction of the
    reference's gyro-bias blocks (dv/dbg = R (dt^2/2 a^ + dt^3/3 (w x a)^ +
    dt^3/6 a^ w^), dp/dbg = R dt^3/6 a^; the reference's are O(dt))."""
    S = dt.shape[0]
    dtype, dev = C_old.dtype, C_old.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    dt1 = dt[:, None]
    dt2 = dt[:, None, None]
    hat = so3.hat
    a_skew = hat(acc)
    w_dt = dt1 * gyro
    JL_plus = so3.left_jacobian(w_dt)
    HL_plus = so3.Hl(w_dt)

    return _assemble(S, {
        (_TH, _TH): so3.exp(-w_dt),
        (_TH, _BG): -dt2 * so3.left_jacobian(-w_dt),
        (_V, _TH): -dt2 * C_old @ hat(torch.einsum("sij,sj->si",
                                                   JL_plus, acc)),
        (_V, _BG): C_old @ (
            (dt2 * dt2 / 2) * a_skew
            + (dt2 ** 3 / 3) * hat(torch.linalg.cross(gyro, acc))
            + (dt2 ** 3 / 6) * a_skew @ hat(gyro)),
        (_V, _BA): -dt2 * C_old @ JL_plus,
        (_P, _TH): -(dt2 * dt2) * C_old @ hat(
            torch.einsum("sij,sj->si", HL_plus, acc)),
        (_P, _V): dt2 * I3,
        (_P, _BG): (dt2 ** 3 / 6) * C_old @ a_skew,
        (_P, _BA): -(dt2 * dt2) * C_old @ HL_plus}, LEG, LEG, I3)


def noise_input_matrix(C_old, use_left_or_larvio: bool):
    """G (S, 22, 12). Ref: orcvio.cpp:773-795. The theta rows take -C_old
    in the left/LARVIO convention, -I in the right one."""
    I3 = torch.eye(3, dtype=C_old.dtype, device=C_old.device)
    return _assemble(C_old.shape[0], {
        (_TH, 0): -C_old if use_left_or_larvio else -I3,
        (_V, 1): -C_old,
        (_BG, 2): I3,
        (_BA, 3): I3}, LEG, 12, I3, eye=False)


def _compose_transitions(Phi, Q, S=None):
    """Fold per-sample (Phi_k, Q_k[, S_k]) into (Phi_tot, Q_tot, S_tot) by
    pairwise tree reduction: Phi_tot = Phi_{S-1} ... Phi_0,
    Q <- Phi_b Q_a Phi_b^T + Q_b, and the intrinsic columns of
    T = [[Phi, S], [0, I]] as S <- Phi_b S_a + S_b (S_tot None without)."""
    n = Phi.shape[0]
    while n > 1:
        m = n // 2
        Pa, Qa = Phi[0: 2 * m: 2], Q[0: 2 * m: 2]
        Pb, Qb = Phi[1: 2 * m: 2], Q[1: 2 * m: 2]
        Pc = Pb @ Pa
        Qc = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
        if S is not None:
            S = torch.cat([Pb @ S[0: 2 * m: 2] + S[1: 2 * m: 2],
                           S[2 * m:]], dim=0)
        if n % 2:
            Pc = torch.cat([Pc, Phi[-1:]], dim=0)
            Qc = torch.cat([Qc, Q[-1:]], dim=0)
        Phi, Q = Pc, Qc
        n = (n + 1) // 2
    return Phi[0], Q[0], None if S is None else S[0]


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


def _corrected(state: FilterState, gyro_m, acc_m):
    """Bias- and intrinsic-corrected (gyro, acc) of measurements (S, 3):
    acc = Ma (a_m - ba), gyro = Tg (w_m - As acc - bg) (orcvio.cpp:732)."""
    acc = (acc_m - state.imu.ba) @ state.Ma.T
    return (gyro_m - acc @ state.As.T - state.imu.bg) @ state.Tg.T, acc


def _bias_intrinsic_sensitivity(cfg: FilterConfig, state: FilterState, pre,
                                post, dt, gyro_m, acc_m):
    """(S, 9, 30) derivative of each sample's propagated [theta v p] error
    with respect to [dbg (3), dba (3), intrinsics (24)] at zero: one
    forward-mode pass (``torch.func.jacfwd``) of the exact mean step from
    ``pre`` = (R, v, p) (each with a leading S axis) against ``post``,
    batched over the slab's samples; each sample's error depends on the
    shared perturbation alone, so the stacked Jacobian is the per-sample
    one. theta in the configured perturbation convention."""
    left = cfg.use_larvio or cfg.use_left_perturbation
    g_w = _constants(cfg, dt.dtype, dt.device)[0]
    (R0, v0, p0), (R1, v1, p1) = pre, post

    def h_err(d):
        Tg, As, Ma = apply_imu_intrinsics_delta(state.Tg, state.As, state.Ma,
                                                d[6:])
        acc = (acc_m - (state.imu.ba + d[3:6])) @ Ma.T
        gyro = (gyro_m - acc @ As.T - (state.imu.bg + d[0:3])) @ Tg.T
        R = R0 @ so3.exp(dt[:, None] * gyro)
        dv, dp = _mean_increments(cfg, R0, R, gyro, acc, dt, g_w)
        M = R @ R1.transpose(-1, -2) if left else R1.transpose(-1, -2) @ R
        return torch.cat([0.5 * so3.vee(M - M.transpose(-1, -2)),
                          v0 + dv - v1, p0 + dt[:, None] * v0 + dp - p1],
                         dim=-1)

    return torch.func.jacfwd(h_err)(torch.zeros(30, dtype=dt.dtype,
                                                device=dt.device))


def imu_batch_transition(cfg: FilterConfig, state: FilterState, imu_t,
                         imu_gyro, imu_acc, imu_mask):
    """Whole-slab propagation: the mean, and the accumulated
    (Phi_tot, Q_tot, S_tot), S_tot None without IMU intrinsics. Returns
    (state, Phi_tot, Q_tot, S_tot, last gyro, last acc)."""
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

    if cfg.calib_imu:
        gyro, acc = _corrected(state, g_eff, a_eff)
        a_prev = torch.cat([state.last_acc[None], a_eff[:-1]])
        gyro_old = _corrected(state, g_prev, a_prev)[0]
    else:
        gyro = g_eff - state.imu.bg
        acc = a_eff - state.imu.ba
        gyro_old = g_prev - state.imu.bg

    # mean: cumulative rotation product, then v/p prefix sums
    w_dt = dt[:, None] * gyro
    cum = _cumulative_product(so3.exp(w_dt))
    R0 = state.imu.R
    R_pre = torch.cat([R0[None], R0 @ cum[:-1]], dim=0)
    R_post = R0 @ cum
    dv, dp_extra = _mean_increments(cfg, R_pre, R_post, gyro, acc, dt, g_w)

    zero = torch.zeros((1, 3), dtype=dtype, device=dev)
    v_cum = torch.cumsum(dv, dim=0)
    v_pre = state.imu.v + torch.cat([zero, v_cum[:-1]], dim=0)
    v_post = state.imu.v + v_cum
    dp = dt[:, None] * v_pre + dp_extra
    p_cum = torch.cumsum(dp, dim=0)
    p_pre = state.imu.p + torch.cat([zero, p_cum[:-1]], dim=0)
    p_post = state.imu.p + p_cum

    left = cfg.use_larvio or cfg.use_left_perturbation
    if cfg.use_larvio or cfg.use_closed_form_cov_prop:
        if left:
            v_k, p_k = v_pre, p_pre
            if cfg.if_fej:
                # sample 0's "old" values are the stored FEJ state; it tracks
                # the propagated mean after that
                v_k = torch.cat([state.imu_fej_now.v[None], v_pre[1:]])
                p_k = torch.cat([state.imu_fej_now.p[None], p_pre[1:]])
            Phi = phi_closed_form_left(R_pre, dt, gyro, acc, gyro_old, v_k,
                                       p_k, v_post, p_post, g_w)
        else:
            Phi = phi_closed_form_right(R_pre, dt, gyro, acc)
    else:
        Phi = phi_euler(R_post, gyro, acc, dt, cfg.use_left_perturbation)
    S_k = None
    if cfg.calib_imu:
        # the analytic bias columns assume identity intrinsics
        B = _bias_intrinsic_sensitivity(cfg, state, (R_pre, v_pre, p_pre),
                                        (R_post, v_post, p_post), dt, g_eff,
                                        a_eff)
        Phi = torch.cat([torch.cat([Phi[:, 0:9, 0:9], B[..., :6],
                                    Phi[:, 0:9, 15:]], dim=2), Phi[:, 9:]],
                        dim=1)
        S_k = torch.cat([B[..., 6:], B.new_zeros((S, LEG - 9, 24))], dim=1)
    G = noise_input_matrix(R_pre, left)
    PhiG = Phi @ G
    Q = PhiG @ Qc @ PhiG.transpose(-1, -2) * dt[:, None, None]
    Phi_tot, Q_tot, S_tot = _compose_transitions(Phi, Q, S_k)

    imu_new = state.imu.replace(R=R_post[-1], v=v_post[-1], p=p_post[-1])
    imu_old = state.imu.replace(R=R_pre[-1], v=v_pre[-1], p=p_pre[-1])
    fej_old = state.imu_fej_now if S == 1 else imu_old
    state2 = state.replace(t=t_eff[-1].to(state.t.dtype), imu=imu_new,
                           imu_old=imu_old, imu_fej_now=imu_new,
                           imu_fej_old=fej_old)
    return state2, Phi_tot, Q_tot, S_tot, g_eff[-1], a_eff[-1]


def apply_leg_covariance(state: FilterState, Phi, Q, S=None,
                         ib: int = 0) -> FilterState:
    """P <- T P T^T + Q with T = [[Phi, S at the intrinsic columns], [0, I]]
    (orcvio.cpp:797-816), then symmetrized. Without S the plain leg
    congruence; with S (22, 24) the intrinsic block at [ib, ib + 24) feeds
    the leg rows (the intrinsics themselves are constant, no noise)."""
    P = state.P
    if S is None:
        P_ll = Phi @ P[:LEG, :LEG] @ Phi.T + Q
        P_lr = Phi @ P[:LEG, LEG:]
        P = torch.cat([torch.cat([P_ll, P_lr], dim=1),
                       torch.cat([P_lr.T, P[LEG:, LEG:]], dim=1)], dim=0)
    else:
        P = torch.cat([Phi @ P[:LEG] + S @ P[ib: ib + 24], P[LEG:]])
        P = torch.cat([P[:, :LEG] @ Phi.T + P[:, ib: ib + 24] @ S.T,
                       P[:, LEG:]], dim=1)
        P = torch.cat([torch.cat([P[:LEG, :LEG] + Q, P[:LEG, LEG:]], dim=1),
                       P[LEG:]])
    return state.replace(P=linalg.symmetrize(P))


def imu_batch(cfg: FilterConfig, state: FilterState, imu_t, imu_gyro, imu_acc,
              imu_mask):
    """Propagate through a per-frame IMU slab. Ref: batchImuProcessing
    (orcvio.cpp:664). imu_t (S,), imu_gyro/imu_acc (S, 3), imu_mask (S,)."""
    state2, Phi, Q, S, g_last, a_last = imu_batch_transition(
        cfg, state, imu_t, imu_gyro, imu_acc, imu_mask)
    state2 = apply_leg_covariance(state2, Phi, Q, S, cfg.intrinsic_base)
    return state2.replace(last_gyro=g_last, last_acc=a_last)


def process_step(cfg: FilterConfig, state: FilterState, t_imu, gyro_m, acc_m,
                 gyro_m_old, acc_m_old) -> FilterState:
    """One IMU sample, mean and covariance, with the previous sample's
    (gyro_m_old, acc_m_old) given. Ref: processModel (orcvio.cpp:727).
    The slab of one sample: ``imu_batch_transition`` then
    ``apply_leg_covariance``; last_gyro and last_acc are left as they
    were. At t_imu == state.t it is an exact no-op."""
    dtype, dev = state.P.dtype, state.P.device
    t = torch.as_tensor(t_imu, dtype=state.t.dtype, device=dev).reshape(1)
    prev = state.replace(last_gyro=gyro_m_old, last_acc=acc_m_old)
    state2, Phi, Q, S, _, _ = imu_batch_transition(
        cfg, prev, t, gyro_m.to(dtype)[None], acc_m.to(dtype)[None],
        torch.ones(1, dtype=torch.bool, device=dev))
    state2 = apply_leg_covariance(state2, Phi, Q, S, cfg.intrinsic_base)
    return state2.replace(last_gyro=state.last_gyro, last_acc=state.last_acc)
