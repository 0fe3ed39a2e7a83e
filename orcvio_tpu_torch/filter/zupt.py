"""Zero-velocity updates (ZUPT): feature- and IMU-based detection + vpq update.

Counterpart of ``orcvio_tpu/filter/zupt.py`` (reference: checkZUPTFeat
orcvio.cpp:3081, checkZUPTIMU :3129, measurementUpdate_ZUPT_vpq :3326),
with the right-perturbation IMU test of the bench flags.
"""
from __future__ import annotations

import torch

from ..config.core import FilterConfig
from ..math import quat, so3
from .propagation import gravity_vec
from .state import LEG, FilterState, take, tree_where
from .update import apply_ekf_update

# OpenVINS-style IMU disturbance noise (orcvio.cpp:3140-3152, hardcoded there)
_SIGMA_W2 = 1.6968e-4**2
_SIGMA_A2 = 2.0e-3**2
_SIGMA_WB = 1.9393e-05
_SIGMA_AB = 3.0e-03
_ZUPT_MAX_VELOCITY = 0.25
_ZUPT_NOISE_V = 1e-2  # zupt_noise_v/p/q (euroc-scale defaults)
_ZUPT_NOISE_P = 1e-2
_ZUPT_NOISE_Q = 1e-2
_INT_MIN = torch.iinfo(torch.int32).min


def _two_newest(order, dim=-1):
    """argmax of order and the argmax once that entry is knocked out."""
    newest = torch.argmax(order, dim=dim, keepdim=True)
    second = torch.argmax(order.scatter(dim, newest, _INT_MIN), dim=dim,
                          keepdim=True)
    return newest, second


def check_zupt_feat(cfg: FilterConfig, state: FilterState,
                    outlier_ignore: int = 8):
    """Static scene from feature motion: >= 20 tracked features and the
    (outlier_ignore+1)-th largest distance between each feature's two newest
    observations below zupt_max_feature_dis. Ref: checkZUPTFeat
    (orcvio.cpp:3081)."""
    ft = state.features
    order = torch.where(ft.uv_valid, state.clones.order[None, :], _INT_MIN)
    newest, second = _two_newest(order)
    has_two = (torch.sum(ft.uv_valid, dim=1) >= 2) & ft.active
    uv_n = torch.take_along_dim(ft.uv, newest[..., None], dim=1)[:, 0]
    uv_p = torch.take_along_dim(ft.uv, second[..., None], dim=1)[:, 0]
    d = torch.where(has_two, torch.linalg.norm(uv_n - uv_p, dim=1), -1.0)
    n = torch.sum(has_two)
    F = d.shape[0]
    k = min(max(F - 1 - outlier_ignore, 0), F - 1)
    max_dis = torch.sort(d).values[k]
    return (n >= 20) & (max_dis < cfg.zupt_max_feature_dis) & (max_dis >= 0)


def zupt_imu_chi2(cfg: FilterConfig, state: FilterState, imu_t, acc_m,
                  imu_mask):
    """The IMU disturbance test's statistic: (chi2, number of sample pairs).

    Residuals per sample: [gyro ~ 0 (zeroed, as the reference does),
    R(acc - ba) + g ~ 0]; marginal covariance over [theta, bg, ba]."""
    S_n = imu_t.shape[0]
    P = state.P
    dtype, dev = P.dtype, P.device
    wRi = state.imu.R
    acc = acc_m - state.imu.ba

    dt = torch.diff(imu_t, prepend=imu_t[:1])
    dt = torch.where(dt > 1e-6, dt, 1e-2)
    pair_mask = imu_mask & torch.roll(imu_mask, 1)
    pair_mask = pair_mask & (torch.arange(S_n, device=dev) > 0)

    r_a = -(torch.einsum("ij,sj->si", wRi, acc)
            + gravity_vec(cfg, dtype, dev))
    r = torch.cat([torch.zeros((S_n, 3), dtype=dtype, device=dev), r_a], dim=1)
    r = torch.where(pair_mask[:, None], r, 0.0)

    # H (S, 6, 9) over [theta, bg, ba], right perturbation
    eye = torch.eye(3, dtype=dtype, device=dev)
    zero = torch.zeros((S_n, 3, 3), dtype=dtype, device=dev)
    H = torch.cat([
        torch.cat([zero, eye.expand(S_n, 3, 3), zero], dim=2),
        torch.cat([wRi @ so3.hat(acc), zero, wRi.expand(S_n, 3, 3)], dim=2),
    ], dim=1)
    H = torch.where(pair_mask[:, None, None], H, 0.0)

    Rdiag = torch.cat([(_SIGMA_W2 / dt)[:, None].expand(S_n, 3),
                       (_SIGMA_A2 / dt)[:, None].expand(S_n, 3)], dim=1)
    Rdiag = torch.where(pair_mask[:, None], Rdiag, 1.0).reshape(-1)

    # marginal P over [theta, bg, ba] + bias random walk (orcvio.cpp:3235-3258)
    P_marg = torch.cat([torch.cat([P[0:3, 0:3], P[0:3, 9:15]], dim=1),
                        torch.cat([P[9:15, 0:3], P[9:15, 9:15]], dim=1)])
    dt_sum = torch.sum(torch.where(pair_mask, dt, 0.0))
    qb = torch.cat([torch.zeros(3, dtype=dtype, device=dev),
                    (dt_sum * _SIGMA_WB).expand(3), (dt_sum * _SIGMA_AB).expand(3)])
    P_marg = P_marg + torch.diag(qb)

    Hm = H.reshape(-1, 9)
    rm = r.reshape(-1)
    S = Hm @ P_marg @ Hm.T + torch.diag(Rdiag)
    x, info = torch.linalg.solve_ex(S, rm)
    return rm @ torch.where(info == 0, x, torch.nan), torch.sum(pair_mask)


def check_zupt_imu(cfg: FilterConfig, state: FilterState, imu_t, gyro_m, acc_m,
                   imu_mask, chi2_table, chi2_multiplier: float = 1.0):
    """IMU disturbance chi-square test. Ref: checkZUPTIMU (orcvio.cpp:3129).
    The gyro rows are zeroed, so gyro_m is not read."""
    chi2, n_pairs = zupt_imu_chi2(cfg, state, imu_t, acc_m, imu_mask)
    dof = torch.clamp(n_pairs * 3, 1, chi2_table.shape[0] - 1)
    ok_chi2 = chi2 < chi2_multiplier * take(chi2_table, dof)
    ok_vel = torch.linalg.norm(state.imu.v) < _ZUPT_MAX_VELOCITY
    return ok_chi2 & ok_vel & (n_pairs >= 2)


def zupt_update(cfg: FilterConfig, state: FilterState):
    """v/p/q pseudo-measurement update on the two newest clones.
    Ref: measurementUpdate_ZUPT_vpq (orcvio.cpp:3326)."""
    D = state.P.shape[0]
    dtype, dev = state.P.dtype, state.P.device
    order = torch.where(state.clones.valid, state.clones.order, _INT_MIN)
    cur, prev = (i[0] for i in _two_newest(order))
    have_two = torch.sum(state.clones.valid) >= 2

    cc = LEG + 6 * cur
    cp = LEG + 6 * prev
    i3 = torch.arange(3, device=dev)

    def block(H, row0, col0, value):  # H[row0:+3, col0:+3] = value * I
        return H.index_put((row0 + i3, col0 + i3),
                           torch.full((3,), value, dtype=dtype, device=dev))

    H = torch.zeros((9, D), dtype=dtype, device=dev)
    H = block(H, 0, 3, 1.0)  # velocity
    H = block(H, 3, cc + 3, 1.0)  # p_curr
    H = block(H, 3, cp + 3, -1.0)  # p_prev
    H = block(H, 6, cc, -0.5)  # q_curr
    H = block(H, 6, cp, 0.5)  # q_prev

    q_c = quat.from_rotation(take(state.clones.R, cur))
    q_p = quat.from_rotation(take(state.clones.R, prev))
    dq = quat.multiply(q_c, quat.inverse(q_p))
    r = torch.cat([-state.imu.v,
                   -(take(state.clones.p, cur) - take(state.clones.p, prev)),
                   dq[:3]])

    # noise-weighted rows so that the shared (sigma^2 I)-noise update applies
    scale = torch.cat([torch.full((3,), cfg.observation_noise / s**0.5,
                                  dtype=dtype, device=dev)
                       for s in (_ZUPT_NOISE_V, _ZUPT_NOISE_P, _ZUPT_NOISE_Q)])
    new_state, _ = apply_ekf_update(cfg, state, H * scale[:, None], r * scale)
    return tree_where(have_two, new_state, state)
