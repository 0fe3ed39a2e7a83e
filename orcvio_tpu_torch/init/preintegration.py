"""IMU preintegration between camera frames (midpoint rule).

Counterpart of ``orcvio_tpu/init/preintegration.py`` (reference:
include/Initializer/ImuPreintegration.h:81, VINS-Mono-style midpoint
preintegration): per frame-gap factors (delta_p, delta_v, delta_R) with
the gyro-bias Jacobians that visual-inertial alignment needs. The JAX
package's ``lax.scan`` over a frame's padded IMU slab is a loop over the
slab here, and its ``vmap`` over frame gaps a leading batch dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import so3


class Preintegration(NamedTuple):
    dR: torch.Tensor  # (..., 3, 3) body_k -> body_{k+1}, R_k^T R_{k+1}
    dv: torch.Tensor  # (..., 3) velocity delta in body_k frame
    dp: torch.Tensor  # (..., 3) position delta in body_k frame
    dt: torch.Tensor  # (...,) total integrated time
    J_q_bg: torch.Tensor  # (..., 3, 3) d(log dR)/d(gyro bias)
    J_v_bg: torch.Tensor  # (..., 3, 3)
    J_p_bg: torch.Tensor  # (..., 3, 3)


def preintegrate(imu_t, gyro, acc, mask, bg, ba):
    """Preintegrate frame gaps: imu_t (..., S), gyro and acc (..., S, 3),
    mask (..., S); bg, ba (3,). Midpoint scheme over consecutive valid
    samples (ImuPreintegration.h:81): the first provides the left endpoint
    only."""
    batch, S = mask.shape[:-1], mask.shape[-1]
    dtype, dev = gyro.dtype, gyro.device
    eye = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))
    zero3 = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    zero33 = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    R, v, p, Jq, Jv, Jp = eye, zero3, zero3, zero33, zero33, zero33
    t_prev = torch.zeros(batch, dtype=dtype, device=dev)
    g_prev, a_prev = zero3, zero3
    started = torch.zeros(batch, dtype=torch.bool, device=dev)
    dt_sum = torch.zeros(batch, dtype=dtype, device=dev)
    for i in range(S):
        t_i, g_i, a_i, m_i = imu_t[..., i], gyro[..., i, :], acc[..., i, :], \
            mask[..., i]
        upd = started & m_i
        dt = torch.where(upd, t_i - t_prev, 0.0)
        dt1, dt2 = dt[..., None], dt[..., None, None]
        g_mid = 0.5 * (g_prev + g_i) - bg
        a0, a1 = a_prev - ba, a_i - ba
        dR_step = so3.exp(g_mid * dt1)
        R_new = R @ dR_step
        a_mid = 0.5 * (torch.einsum("...ij,...j->...i", R, a0)
                       + torch.einsum("...ij,...j->...i", R_new, a1))
        v_new = v + a_mid * dt1
        p_new = p + v * dt1 + 0.5 * a_mid * dt1 * dt1
        # bias Jacobians (first-order, VINS midpoint approximation)
        Jr = so3.left_jacobian(-g_mid * dt1)  # right Jacobian of exp
        Jq_new = dR_step.transpose(-1, -2) @ Jq - Jr * dt2
        RaJ = R @ so3.hat(a0) @ Jq
        Jv_new = Jv - RaJ * dt2
        Jp_new = Jp + Jv * dt2 - 0.5 * RaJ * dt2 * dt2
        u1, u2 = upd[..., None], upd[..., None, None]
        R, v, p = (torch.where(u2, R_new, R), torch.where(u1, v_new, v),
                   torch.where(u1, p_new, p))
        Jq, Jv, Jp = (torch.where(u2, Jq_new, Jq), torch.where(u2, Jv_new, Jv),
                      torch.where(u2, Jp_new, Jp))
        t_prev = torch.where(m_i, t_i, t_prev)
        g_prev = torch.where(m_i[..., None], g_i, g_prev)
        a_prev = torch.where(m_i[..., None], a_i, a_prev)
        started = started | m_i
        dt_sum = dt_sum + dt
    return Preintegration(dR=R, dv=v, dp=p, dt=dt_sum, J_q_bg=Jq, J_v_bg=Jv,
                          J_p_bg=Jp)


def preintegrate_sequence(imu_t, gyro, acc, mask, bg=None, ba=None):
    """All frame gaps at once: inputs (K, S, ...) -> Preintegration with a
    leading K.

    Each frame's slab covers (t_{k-1}, t_k], so slab k is the support of
    gap (k-1, k); its left endpoint, the last valid sample of the previous
    slab, is prepended to it."""
    K, S = mask.shape
    dtype, dev = gyro.dtype, gyro.device
    bg = torch.zeros(3, dtype=dtype, device=dev) if bg is None else bg
    ba = torch.zeros(3, dtype=dtype, device=dev) if ba is None else ba
    idx = torch.clamp(torch.sum(mask, dim=1) - 1, min=0)  # last valid
    ar = torch.arange(K, device=dev)
    lt, lg, la, lm = imu_t[ar, idx], gyro[ar, idx], acc[ar, idx], mask[ar, idx]
    # shift by one: gap k uses the previous slab's endpoint
    pt = torch.cat([imu_t[:1, :1] * 0 - 1e9, lt[:-1, None]], dim=0)
    pg = torch.cat([torch.zeros((1, 1, 3), dtype=dtype, device=dev),
                    lg[:-1, None]], dim=0)
    pa = torch.cat([torch.zeros((1, 1, 3), dtype=dtype, device=dev),
                    la[:-1, None]], dim=0)
    pm = torch.cat([torch.zeros((1, 1), dtype=torch.bool, device=dev),
                    lm[:-1, None]], dim=0)
    return preintegrate(torch.cat([pt, imu_t], dim=1),
                        torch.cat([pg, gyro], dim=1),
                        torch.cat([pa, acc], dim=1),
                        torch.cat([pm, mask], dim=1), bg, ba)
