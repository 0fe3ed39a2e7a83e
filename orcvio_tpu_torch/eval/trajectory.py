"""Trajectory evaluation: ATE with SE(3), Sim(3) or yaw alignment, and the
relative error (numpy).

The port's own copy of ``orcvio_tpu/eval/trajectory.py`` (reference:
python_scripts/trajectory_eval, rpg_trajectory_evaluation):
nearest-timestamp association, Umeyama alignment, ATE and the KITTI-style
relative error. Evaluation is host-side and off the hot path.
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


def umeyama(src, dst, with_scale=False):
    """Least-squares similarity transform dst ~ s R src + t (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((sc**2).sum() / len(src)) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


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


def ate(t_est, p_est, q_est, t_gt, p_gt, q_gt, alignment="se3", max_dt=0.02):
    """Absolute trajectory error after alignment: "se3", "sim3", "posyaw"
    or "none".

    Returns {"rmse_trans" (m), "rmse_rot_deg", "mean_trans",
    "median_trans", "n_matched", "scale"}."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        raise ValueError(f"too few associations: {len(ie)}")
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    if alignment in ("se3", "sim3"):
        s, R, t = umeyama(pe, pg, with_scale=alignment == "sim3")
    elif alignment == "posyaw":
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


def relative_errors(t_est, p_est, t_gt, p_gt,
                    distances=(8.0, 16.0, 24.0, 32.0), max_dt=0.02):
    """KITTI-style relative translation error (%) over sub-trajectory
    lengths: {distance: mean error} for each distance the track spans."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    dist = np.concatenate(
        [[0], np.cumsum(np.linalg.norm(np.diff(pg, axis=0), axis=1))])
    out = {}
    for d in distances:
        errs = []
        for i in range(len(pg)):
            j = np.searchsorted(dist, dist[i] + d)
            if j >= len(pg):
                break
            err = (pe[j] - pe[i]) - (pg[j] - pg[i])
            errs.append(np.linalg.norm(err) / max(d, 1e-9) * 100.0)
        if errs:
            out[d] = float(np.mean(errs))
    return out
