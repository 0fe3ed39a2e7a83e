"""Object-level Levenberg-Marquardt over {pose, shape, keypoints}.

Counterpart of ``orcvio_tpu/objects/lm.py`` (reference: the vendored
MINPACK LM of ``include/orcvio/utils/EigenLevenbergMarquardt/`` driving
``ObjectLM``, full: DoF 6 + 3 + 3K, four residual blocks, and
``ObjectLMLite``, DoF 9, bbox only; ``single_levenberg_marquardt[_lite]``,
ObjectFeatureInitializer.cpp:343-500). The JAX package's fixed budget of
damped normal-equation steps with accept or reject, run as a Python loop
of ``iters`` steps; the retraction follows the perturbation flag
(ObjectLM.cpp:63-70 always retracts left). The damped system is solved
with ``solve_ex`` (no host read of its error flag; a singular system
gives NaN).

Also the pieces the object EKF update consumes: the feature and bbox
residuals and their Jacobians wrt the object and each camera pose
(fvec_all / fjac_object_state_all / fjac_sensor_state_all,
ObjectFeatureInitializer.h:100-110).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import se3
from . import residuals as R


class ObjectLMConfig(NamedTuple):
    iters: int = 20
    init_lambda: float = 1e-4
    residual_weights: tuple = (1.0, 1.0, 1.0, 1.0)  # feature, bbox, deform, shape
    huber_epsilon: float = float("inf")
    use_left_perturbation: bool = True
    use_new_bbox_residual: bool = False
    lite: bool = False  # bbox only, state {pose, shape} (ObjectLMLite)


class ObjectLMState(NamedTuple):
    wTo: torch.Tensor  # (4, 4)
    shape: torch.Tensor  # (3,)
    kps: torch.Tensor  # (K, 3)


class ObjectLMData(NamedTuple):
    cTw: torch.Tensor  # (T, 4, 4)
    zs: torch.Tensor  # (T, K, 2)
    zs_mask: torch.Tensor  # (T, K)
    zb: torch.Tensor  # (T, 4)
    zb_mask: torch.Tensor  # (T,)
    frame_mask: torch.Tensor  # (T,) frames that observe the object
    kps_mean: torch.Tensor  # (K, 3)
    shape_mean: torch.Tensor  # (3,)


def residual_stack(cfg: ObjectLMConfig, st: ObjectLMState, d: ObjectLMData):
    """The weighted stacked residual [feature; bbox; deform; shape], Huber
    applied."""
    w = cfg.residual_weights
    rb = R.bbox_residual(st.wTo, st.shape, d.cTw, d.zb, d.zb_mask,
                         cfg.use_new_bbox_residual).reshape(-1) * w[1]
    if cfg.lite:
        r = rb
    else:
        rf = R.feature_residual(st.wTo, st.kps, d.cTw, d.zs,
                                d.zs_mask).reshape(-1) * w[0]
        rd = R.deform_residual(st.kps, d.kps_mean,
                               d.frame_mask).reshape(-1) * w[2]
        rs = R.shape_residual(st.shape, d.shape_mean,
                              d.frame_mask).reshape(-1) * w[3]
        r = torch.cat([rf, rb, rd, rs])
    return R.huber_apply(r, cfg.huber_epsilon)


def _object_columns(J_pose, J_kp):
    """(..., K, 2, 9 + 3K) rows: the pose block at columns 0:6, zeros at
    the shape's 6:9 and keypoint k's block at 9 + 3k (the JAX package's
    scatter into zeros)."""
    K = J_kp.shape[-3]
    eye = torch.eye(K, dtype=J_kp.dtype, device=J_kp.device)
    # (..., K, 2, 3) -> (..., K, 2, K, 3) -> (..., K, 2, 3K)
    kp = (J_kp[..., None, :] * eye[:, None, :, None]).flatten(-2)
    shape_cols = torch.zeros_like(J_pose[..., :3])
    return torch.cat([J_pose, shape_cols, kp], dim=-1)


def jacobian_stack(cfg: ObjectLMConfig, st: ObjectLMState, d: ObjectLMData):
    """The weighted stacked Jacobian wrt the object error state. Full:
    columns [pose (6) | shape (3) | kp_0 .. kp_{K-1} (3K)]; lite: [pose |
    shape]."""
    T, K = d.zs_mask.shape
    dof = 9 + (0 if cfg.lite else 3 * K)
    w = cfg.residual_weights
    dtype, dev = st.wTo.dtype, st.wTo.device
    raw = residual_stack(cfg._replace(huber_epsilon=float("inf")), st, d)
    scale = R.huber_jac_scale(raw, cfg.huber_epsilon)[:, None]

    Jp_b, Js_b, _ = R.bbox_jacobians(
        st.wTo, st.shape, d.cTw, d.zb, d.zb_mask, cfg.use_left_perturbation,
        cfg.use_new_bbox_residual)
    Jb = torch.cat([Jp_b.reshape(-1, 6), Js_b.reshape(-1, 3),
                    torch.zeros((T * 4, dof - 9), dtype=dtype, device=dev)],
                   dim=1) * w[1]
    if cfg.lite:
        return Jb * scale

    Jp_f, Jk_f, _ = R.feature_jacobians(st.wTo, st.kps, d.cTw, d.zs_mask,
                                        cfg.use_left_perturbation)
    Jf = _object_columns(Jp_f, Jk_f).reshape(T * K * 2, dof) * w[0]
    # deform: identity blocks on the keypoint columns of each frame
    # (ObjectLM.h:463); shape: identity on the shape columns
    eye = torch.eye(dof, dtype=dtype, device=dev)
    fm = d.frame_mask.to(dtype)[:, None, None]
    Jd = (eye[9:] * fm).reshape(-1, dof) * w[2]
    Jsr = (eye[6:9] * fm).reshape(-1, dof) * w[3]
    return torch.cat([Jf, Jb, Jd, Jsr], dim=0) * scale


def retract(cfg: ObjectLMConfig, st: ObjectLMState, dx):
    """Apply an error-state step (LMObjectState operator+,
    ObjectLM.cpp:211)."""
    dT = se3.exp(dx[:6])
    wTo = dT @ st.wTo if cfg.use_left_perturbation else st.wTo @ dT
    shape = st.shape + dx[6:9]
    if cfg.lite:
        return st._replace(wTo=wTo, shape=shape)
    K = st.kps.shape[0]
    return st._replace(wTo=wTo, shape=shape,
                       kps=st.kps + dx[9:9 + 3 * K].reshape(K, 3))


def optimize(cfg: ObjectLMConfig, st0: ObjectLMState, d: ObjectLMData):
    """Fixed-iteration damped LM: (state, final cost, accepted steps)."""
    dof = 9 + (0 if cfg.lite else 3 * st0.kps.shape[0])
    dtype, dev = st0.wTo.dtype, st0.wTo.device
    eye = torch.eye(dof, dtype=dtype, device=dev)

    def cost_of(st):
        r = residual_stack(cfg, st, d)
        return torch.sum(r * r)

    st, cost = st0, cost_of(st0)
    lam = torch.full((), cfg.init_lambda, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.iters):
        r = residual_stack(cfg, st, d)
        J = jacobian_stack(cfg, st, d)
        sol, info = torch.linalg.solve_ex(J.T @ J + lam * eye,
                                          (J.T @ r)[:, None])
        delta = torch.where(info == 0, sol[:, 0], torch.nan)
        st_new = retract(cfg, st, -delta)
        cost_new = cost_of(st_new)
        accept = cost_new < cost
        st = ObjectLMState(*(torch.where(accept, a, b)
                             for a, b in zip(st_new, st)))
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, torch.clamp(lam / 10.0, min=1e-12),
                          torch.clamp(lam * 10.0, max=1e10))
        n_acc = n_acc + accept.to(torch.int32)
    return st, cost, n_acc


class EkfExport(NamedTuple):
    """What the EKF camera-pose update consumes
    (ObjectFeatureInitializer.h:100)."""

    r_feat: torch.Tensor  # (T, K, 2)
    r_bbox: torch.Tensor  # (T, 4)
    J_obj_feat: torch.Tensor  # (T, K, 2, dof)
    J_obj_bbox: torch.Tensor  # (T, 4, dof)
    J_cam_feat: torch.Tensor  # (T, K, 2, 6)
    J_cam_bbox: torch.Tensor  # (T, 4, 6)
    zs_mask: torch.Tensor  # (T, K)
    zb_mask: torch.Tensor  # (T,)


def export_for_update(cfg: ObjectLMConfig, st: ObjectLMState,
                      d: ObjectLMData) -> EkfExport:
    """Residuals and Jacobians (object and camera) of the feature and bbox
    blocks only. Ref: single_levenberg_marquardt's export
    (ObjectFeatureInitializer.cpp:395-435, residual_size_to_keep = the
    feature and bbox rows)."""
    K = st.kps.shape[0]
    w = cfg.residual_weights
    dof = 9 + 3 * K
    r_feat = R.feature_residual(st.wTo, st.kps, d.cTw, d.zs, d.zs_mask) * w[0]
    r_bbox = R.bbox_residual(st.wTo, st.shape, d.cTw, d.zb, d.zb_mask,
                             cfg.use_new_bbox_residual) * w[1]
    Jp_f, Jk_f, Jc_f = R.feature_jacobians(st.wTo, st.kps, d.cTw, d.zs_mask,
                                           cfg.use_left_perturbation)
    Jp_b, Js_b, Jc_b = R.bbox_jacobians(
        st.wTo, st.shape, d.cTw, d.zb, d.zb_mask, cfg.use_left_perturbation,
        cfg.use_new_bbox_residual)
    J_obj_bbox = torch.cat([Jp_b, Js_b, torch.zeros_like(Jp_b[..., :1]).expand(
        Jp_b.shape[:-1] + (dof - 9,))], dim=-1)
    return EkfExport(
        r_feat=r_feat, r_bbox=r_bbox,
        J_obj_feat=_object_columns(Jp_f, Jk_f) * w[0],
        J_obj_bbox=J_obj_bbox * w[1],
        J_cam_feat=Jc_f * w[0], J_cam_bbox=Jc_b * w[1],
        zs_mask=d.zs_mask, zb_mask=d.zb_mask)
