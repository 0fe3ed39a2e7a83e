"""Trajectory evaluation: ATE after position + yaw alignment (numpy).

The port's own copy of what it needs from ``orcvio_tpu/eval/trajectory.py``
(reference: python_scripts/trajectory_eval, rpg_trajectory_evaluation):
nearest-timestamp association and the gravity-aligned 4-DoF ("posyaw")
alignment that VIO is scored with. Evaluation is host-side and off the hot
path.
"""
from __future__ import annotations

import numpy as np


def _quat_to_R(q_xyzw):
    x, y, z, w = np.moveaxis(np.asarray(q_xyzw), -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def associate(t_est, t_gt, max_dt=0.02):
    """Nearest-timestamp association; returns (idx_est, idx_gt)."""
    j = np.clip(np.searchsorted(t_gt, t_est), 1, len(t_gt) - 1)
    jj = np.where(t_est - t_gt[j - 1] < t_gt[j] - t_est, j - 1, j)
    ok = np.abs(t_gt[jj] - t_est) <= max_dt
    return np.nonzero(ok)[0], jj[ok]


def align_yaw_only(src, dst):
    """Position + yaw alignment (the gravity-aligned VIO-standard 4-DoF)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    c = (sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum()
    s_ = (sc[:, 0] * dc[:, 0] + sc[:, 1] * dc[:, 1]).sum()
    yaw = np.arctan2(c, s_)
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                  [0, 0, 1.0]])
    return 1.0, R, mu_d - R @ mu_s


def ate(t_est, p_est, q_est, t_gt, p_gt, q_gt, alignment="posyaw", max_dt=0.02):
    """Absolute trajectory error after alignment ("posyaw" or "none").

    Returns {"rmse_trans" (m), "rmse_rot_deg", "mean_trans",
    "median_trans", "n_matched", "scale"}."""
    if alignment not in ("posyaw", "none"):
        raise NotImplementedError(f"alignment {alignment!r}: the port keeps "
                                  "posyaw and none")
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        raise ValueError(f"too few associations: {len(ie)}")
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    if alignment == "posyaw":
        s, R, t = align_yaw_only(pe, pg)
    else:
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    e_trans = np.linalg.norm((s * (R @ pe.T)).T + t - pg, axis=1)
    Re = _quat_to_R(np.asarray(q_est)[ie])
    Rg = _quat_to_R(np.asarray(q_gt)[ig])
    Rel = np.einsum("nij,nkj->nik", R @ Re, Rg)
    tr = np.clip((np.trace(Rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    e_rot = np.degrees(np.arccos(tr))
    return {
        "rmse_trans": float(np.sqrt((e_trans**2).mean())),
        "rmse_rot_deg": float(np.sqrt((e_rot**2).mean())),
        "mean_trans": float(e_trans.mean()),
        "median_trans": float(np.median(e_trans)),
        "n_matched": int(len(ie)),
        "scale": float(s),
    }
