"""Object-residual EKF update of the sliding window's camera states.

Counterpart of ``orcvio_tpu/objects/update.py`` (reference:
``OrcVIO::constructObjectResidualJacobians``, orcvio.cpp:2017, which maps
each frame's object residual Jacobians wrt the camera pose into the
window's columns through d(campose)/d(imupose), and
``OrcVIO::removeLostObjects`` :2154: project the object's block out,
chi-square gate, then the MSCKF update). Frames not found in the window
give exact zero rows, neutral through the projection, the gate and the
update. The update itself is the filter's ``apply_ekf_update``, so its
covariance step is kernel K4.

The projection onto H_f's left nullspace keeps the port's Householder
loop at every width (k = 9 + 3K columns; the JAX package takes a
complete QR above k = 8). The two differ by an orthogonal transform of
the rows, to which S, the gate's statistic, the update and the
covariance are invariant.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..filter.state import LEG, FilterState, take
from ..filter.update import apply_ekf_update
from ..math import linalg, se3
from ..tree import tree_where
from .lm import EkfExport


def match_timestamps(obj_t, clone_t, clone_valid, tol=1e-6):
    """For each object frame time, the matching clone slot (or -1), and
    whether there is one. Ref: std::find over cur_window_timestamps
    (orcvio.cpp:2074)."""
    d = torch.abs(obj_t[:, None] - clone_t[None, :])
    d = torch.where(clone_valid[None, :], d, torch.inf)
    ok = torch.amin(d, dim=1) < tol
    return torch.where(ok, torch.argmin(d, dim=1), -1), ok


def build_object_H(cfg: FilterConfig, state: FilterState, exp: EkfExport,
                   wTc_obj, obj_t):
    """(H_x (M, D), H_f (M, dof_obj), r (M,), row_mask (M,), any frame
    matched) for one object, M = T (2K + 4). wTc_obj (T, 4, 4): the camera
    poses the object LM linearized at; obj_t (T,). Ref:
    constructObjectResidualJacobians."""
    T, K, _ = exp.r_feat.shape
    D = state.P.shape[0]
    dof_obj = exp.J_obj_feat.shape[-1]
    sw = state.clones.valid.shape[0]
    slot, matched = match_timestamps(obj_t, state.clones.t,
                                     state.clones.valid)
    sl = torch.clamp(slot, 0, sw - 1)

    # d(campose)/d(imupose) per frame at the object's linearization poses
    # (orcvio.cpp:2078-2092)
    R_b2c, t_c_b = state.R_b2c, state.t_c_b
    R_w2c = wTc_obj[:, :3, :3].transpose(-1, -2)
    t_b_w = (torch.einsum("tij,j->ti", wTc_obj[:, :3, :3], -R_b2c @ t_c_b)
             + wTc_obj[:, :3, 3])
    dcam = se3.get_cam_wrt_imu_se3_jacobian(R_b2c, t_c_b, R_w2c, t_b_w,
                                            cfg.use_left_perturbation)

    # per frame 2K feature rows, then 4 bbox rows (orcvio.cpp:2098-2126)
    Jx_feat = torch.einsum("tkri,tij->tkrj", exp.J_cam_feat, dcam)
    Jx_bbox = torch.einsum("tri,tij->trj", exp.J_cam_bbox, dcam)
    Hx_frame = torch.cat([Jx_feat.reshape(T, 2 * K, 6), Jx_bbox], dim=1)
    Hf_frame = torch.cat([exp.J_obj_feat.reshape(T, 2 * K, dof_obj),
                          exp.J_obj_bbox], dim=1)
    r_feat, r_bbox = exp.r_feat, exp.r_bbox
    if cfg.object_residual_transport:
        # carry the residual from the LM's pose-history poses to the
        # current clone estimates, to first order: r_now = r_lm + J_cam xi,
        # xi the log of the increment from the LM's camera pose to the
        # clone's (left: wTc' = exp(xi) wTc, right: wTc' = wTc exp(xi))
        R_sl = state.clones.R[sl]
        wTc_now = se3.make_pose(
            R_sl @ R_b2c.T,
            state.clones.p[sl] + torch.einsum("tij,j->ti", R_sl, t_c_b))
        if cfg.use_left_perturbation:
            inc = wTc_now @ se3.inverse_pose(wTc_obj)
        else:
            inc = se3.inverse_pose(wTc_obj) @ wTc_now
        xi = torch.where(matched[:, None], se3.log(inc), 0.0)
        r_feat = r_feat + torch.einsum("tkri,ti->tkr", exp.J_cam_feat, xi)
        r_bbox = r_bbox + torch.einsum("tri,ti->tr", exp.J_cam_bbox, xi)
    r_frame = torch.cat([r_feat.reshape(T, 2 * K), r_bbox], dim=1)

    row_mask_frame = torch.cat([
        torch.repeat_interleave(exp.zs_mask, 2, dim=1),
        exp.zb_mask[:, None].expand(T, 4)], dim=1) & matched[:, None]

    # each frame's 6 columns land at its clone's window columns
    dev = state.P.device
    cols = (LEG + 6 * sl)[:, None, None] + torch.arange(6, device=dev)
    Hx = torch.zeros((T, 2 * K + 4, D), dtype=Hx_frame.dtype, device=dev)
    Hx = Hx.scatter(-1, cols.expand(T, 2 * K + 4, 6), Hx_frame)
    m = row_mask_frame[..., None]
    M_rows = T * (2 * K + 4)
    Hx = torch.where(m, Hx, 0.0).reshape(M_rows, D)
    Hf = torch.where(m, Hf_frame, 0.0).reshape(M_rows, dof_obj)
    # a deliberate deviation, as the JAX package's: the LM exports
    # prediction - z while H is the prediction's derivative, and the
    # Kalman step needs r ~ +H dx, i.e. z - prediction; the reference
    # feeds prediction - z with +H (orcvio.cpp:2098-2126), which
    # tests/test_objects_update.py shows is sign-inconsistent
    r = -torch.where(row_mask_frame, r_frame, 0.0).reshape(M_rows)
    return Hx, Hf, r, row_mask_frame.reshape(M_rows), torch.any(matched)


class UpdateDiag(NamedTuple):
    """Diagnostics of one update (0-d tensors)."""

    gamma: torch.Tensor  # the chi-square statistic r' S^-1 r
    dof: torch.Tensor  # the gate's dof (clipped to the table)
    threshold: torch.Tensor  # the table's value at dof
    n_rows: torch.Tensor  # active residual rows
    n_frames: torch.Tensor  # object frames found in the window
    gate_ok: torch.Tensor
    dx_clone_p: torch.Tensor  # norm of the clone position correction
    r_rms: torch.Tensor  # RMS of the active raw residual rows
    rp_rms: torch.Tensor  # RMS of the projected residual
    h_max: torch.Tensor  # max |H_x| after the projection (basis-dependent)


def object_ekf_update(cfg: FilterConfig, state: FilterState, exp: EkfExport,
                      wTc_obj, obj_t, chi2_table):
    """The object update: build H, project, gate, update. Ref:
    removeLostObjects (orcvio.cpp:2154). Returns (state, used, UpdateDiag);
    the state is the one given where the update is not used. Nothing is
    read back to the host: the gate's solve is ``solve_ex``, and the
    update's Cholesky ``cholesky_ex``."""
    Hx, Hf, r, row_mask, any_match = build_object_H(cfg, state, exp, wTc_obj,
                                                    obj_t)
    n_rows = torch.sum(row_mask)
    dof_obj = Hf.shape[1]
    enough = n_rows > dof_obj  # the projection needs rows > cols
    Hx_p, r_p = linalg.nullspace_project(Hf, Hx, r)

    # the gate's dof is the rows left after the projection (orcvio.cpp:2172)
    sigma_obj = cfg.object_observation_noise or cfg.observation_noise
    P = state.P
    S = Hx_p @ P @ Hx_p.T + sigma_obj**2 * torch.eye(
        Hx_p.shape[0], dtype=P.dtype, device=P.device)
    sol, info = torch.linalg.solve_ex(S, r_p[:, None])
    gamma = torch.where(info == 0, r_p @ sol[:, 0], torch.nan)
    dof = torch.clamp(n_rows - dof_obj, 1, chi2_table.shape[0] - 1)
    threshold = take(chi2_table, dof)
    gate_ok = gamma < threshold
    finite = torch.all(torch.isfinite(Hx_p)) & torch.all(torch.isfinite(r_p))
    use = any_match & enough & gate_ok & finite

    # apply_ekf_update takes R = observation_noise^2 I: scaling rows by
    # c = observation_noise / sigma_obj makes the noise sigma_obj exactly
    c = cfg.observation_noise / sigma_obj
    new_state, dx = apply_ekf_update(cfg, state, c * Hx_p, c * r_p)
    out = tree_where(use, new_state, state)
    nr = torch.clamp(n_rows, min=1)
    diag = UpdateDiag(
        gamma=gamma, dof=dof, threshold=threshold, n_rows=n_rows,
        n_frames=torch.sum(match_timestamps(obj_t, state.clones.t,
                                            state.clones.valid)[1]),
        gate_ok=gate_ok,
        dx_clone_p=torch.linalg.norm(new_state.clones.p - state.clones.p),
        r_rms=torch.sqrt(torch.sum(r**2) / nr),
        rp_rms=torch.sqrt(torch.sum(r_p**2) / nr),
        h_max=torch.amax(torch.abs(Hx_p)))
    return out, use, diag
