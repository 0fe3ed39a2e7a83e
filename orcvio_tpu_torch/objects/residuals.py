"""Object-level residual blocks and their analytic Jacobians.

Counterpart of ``orcvio_tpu/objects/residuals.py`` (reference: the object
LM functors of ``src/obj/ObjectLM.cpp``: ErrorFeatureQuadric :272,
ErrorBBoxQuadric :443 with ``ellipse_from_shape`` :407, ``bbox2poly`` :380
and ``poly2lineh`` :394, the deform and shape regularizers ObjectLM.h:463-515,
Huber :823; the camera-pose Jacobians of ``src/obj/ObjectResJacCam.cpp``).

Every function works on one object over a fixed window of frames, with
masks: zs (T, K, 2) keypoint measurements (zs_mask), zb (T, 4) bboxes
(zb_mask), camera poses cTw (T, 4, 4). Masked rows are exact zeros.
Object state: wTo (4, 4), shape (3,) ellipsoid semi-axes, kps_o (K, 3)
keypoints in the object frame; error-state layout [pose twist (6) | shape
(3) | kp_0 .. kp_{K-1} (3K)] (ObjectLM.h:117). Residuals are prediction -
measurement, as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..math import se3


def ellipse_from_shape(shape):
    """Dual quadric of the ellipsoid: diag(a^2, b^2, c^2, -1). Ref:
    ObjectLM.cpp:407."""
    return torch.diag(torch.cat([shape * shape, -torch.ones_like(shape[:1])]))


def bbox2poly(bbox):
    """(..., 4) xmin, ymin, xmax, ymax -> (..., 4, 2) corners. Ref:
    ObjectLM.cpp:380."""
    xmin, ymin, xmax, ymax = bbox[..., 0], bbox[..., 1], bbox[..., 2], \
        bbox[..., 3]
    return torch.stack([torch.stack([xmin, ymin], -1),
                        torch.stack([xmax, ymin], -1),
                        torch.stack([xmax, ymax], -1),
                        torch.stack([xmin, ymax], -1)], dim=-2)


def poly2lineh(points):
    """Polygon corners (..., N, 2) -> homogeneous edge lines (..., N, 3):
    the cross products of consecutive homogeneous corners. Ref:
    ObjectLM.cpp:394."""
    ph = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.linalg.cross(ph, torch.roll(ph, -1, dims=-2), dim=-1)


def bbox_lines(zb):
    """(..., 4) bbox -> (..., 4, 3) edge lines."""
    return poly2lineh(bbox2poly(zb))


# --- the feature (keypoint reprojection) block ------------------------------

def _kps_h(kps_o, T):
    K = kps_o.shape[0]
    return se3.to_homogeneous(kps_o).expand(T, K, 4)


def feature_residual(wTo, kps_o, cTw, zs, zs_mask):
    """r[t, k] = project([I|0] cTw wTo kp_k) - zs[t, k], masked. Ref:
    ObjectLM.cpp:272."""
    P = cTw[..., :3, :]  # (T, 3, 4), normalized coordinates
    uv = se3.project_object_points(P, wTo, _kps_h(kps_o, cTw.shape[0]))
    return torch.where(zs_mask[..., None], uv - zs, 0.0)


def feature_jacobians(wTo, kps_o, cTw, zs_mask, use_left: bool):
    """(J_pose (T, K, 2, 6), J_kp (T, K, 2, 3), J_cam (T, K, 2, 6)). Ref:
    ObjectLM.cpp:318, ObjectResJacCam.cpp:228."""
    kps_h = _kps_h(kps_o, cTw.shape[0])
    P = cTw[..., :3, :]
    J_pose = se3.project_object_points_df_object(P, wTo, kps_h, use_left)
    # keypoint block: dpi(P wTo kp) (P wTo)[:, :3] (ObjectLM.cpp:344)
    PT = torch.einsum("tij,jk->tik", P, wTo)
    dpi = se3.project_image_df(torch.einsum("tij,tkj->tki", PT, kps_h))
    J_kp = dpi @ PT[:, None, :, :3]
    J_cam = se3.project_object_points_df_camera(P, wTo, cTw, kps_h, use_left)
    m = zs_mask[..., None, None]
    return (torch.where(m, J_pose, 0.0), torch.where(m, J_kp, 0.0),
            torch.where(m, J_cam, 0.0))


# --- the bbox (quadric tangency) block --------------------------------------

def _new_terms(P_o, lines, Qi):
    """uline_b = P_o^T l per line and the pieces of the normalized
    residual: (uline_b, b, bh, sqrt(b^T U^2 b), sign(bh), |b|)."""
    uline_b = torch.einsum("tji,tnj->tni", P_o, lines)
    b = uline_b[..., :3]
    bh = uline_b[..., 3]
    bU2b = torch.einsum("tni,ij,tnj->tn", b, Qi[:3, :3], b)
    sqrt_bU2b = torch.sqrt(torch.clamp(bU2b, min=1e-12))
    sign = torch.where(bh > 0, 1.0, -1.0).to(b.dtype)
    bnorm = torch.clamp(torch.linalg.norm(b, dim=-1), min=1e-12)
    return uline_b, b, bh, sqrt_bU2b, sign, bnorm


def bbox_residual(wTo, shape, cTw, zb, zb_mask, use_new: bool):
    """The per-frame 4-line residual (T, 4), masked. Ref:
    ObjectLM.cpp:443-486."""
    Qi = ellipse_from_shape(shape)
    lines = bbox_lines(zb)
    P_o = torch.einsum("tij,jk->tik", cTw[..., :3, :], wTo)
    if not use_new:
        Ci = torch.einsum("tij,jk,tlk->til", P_o, Qi, P_o)
        r = torch.einsum("tni,tij,tnj->tn", lines, Ci, lines)
    else:
        _, _, bh, sqrt_bU2b, sign, bnorm = _new_terms(P_o, lines, Qi)
        r = (bh - sign * sqrt_bU2b) / bnorm
    return torch.where(zb_mask[:, None], r, 0.0)


def bbox_jacobians(wTo, shape, cTw, zb, zb_mask, use_left: bool,
                   use_new: bool):
    """(J_pose (T, 4, 6), J_shape (T, 4, 3), J_cam (T, 4, 6)). Ref:
    ObjectLM.cpp:503-613, ObjectResJacCam.cpp:396."""
    dtype, dev = wTo.dtype, wTo.device
    Qi = ellipse_from_shape(shape)
    lines = bbox_lines(zb)
    P = cTw[..., :3, :]
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    yyw = torch.einsum("tnl,tlj->tnj", lines, P)
    yyw_prime = lines @ eye4[:3]  # lines [I|0]
    yyo = torch.einsum("tnj,jk->tnk", yyw, wTo)

    if not use_new:
        # e = yyo Qi yyo^T
        v = torch.einsum("tnj,jk->tnk", yyo, Qi)
        if use_left:
            # 2 yyo Qi wTo^T circledCirc(yyw)^T (ObjectLM.cpp:540)
            cc = se3.circled_circ(yyw)
            vw = torch.einsum("tnk,jk->tnj", v, wTo)
            J_pose = 2.0 * torch.einsum("tnj,tnqj->tnq", vw, cc)
        else:
            cc = se3.circled_circ(torch.einsum("kj,tnj->tnk", wTo.T, yyw))
            J_pose = 2.0 * torch.einsum("tnj,tnqj->tnq", v, cc)
        # 2 shape .* (yyo[:3])^2 (ObjectLM.cpp:567)
        J_shape = 2.0 * shape[None, None, :] * (yyo[..., :3] ** 2)
        if use_left:  # ObjectResJacCam.cpp:424-439
            J_cam = -J_pose
        else:
            ccp = se3.circled_circ(yyw_prime)
            vw = torch.einsum("tnk,jk->tnj", v, wTo)
            vwc = torch.einsum("tnj,tkj->tnk", vw, cTw)
            J_cam = -2.0 * torch.einsum("tnj,tnqj->tnq", vwc, ccp)
    else:
        P_o = torch.einsum("tij,jk->tik", P, wTo)
        uline_b, b, _, sqrt_bU2b, sign, bnorm = _new_terms(P_o, lines, Qi)
        sqrt_bU2b, sign, bnorm = (x[..., None] for x in (sqrt_bU2b, sign,
                                                          bnorm))
        # d e / d uline_b (1x4): e_3 - sign uline_b^T Qi' / sqrt
        term1a = eye4[3]
        not33 = 1.0 - eye4[:, 3:] * eye4[3:, :]  # ones but at [3, 3]
        term2a = Qi * not33
        p_be_p_ulinea = term1a[None, None] - sign * torch.einsum(
            "tnj,jk->tnk", uline_b, term2a) / sqrt_bU2b
        eye_t = eye4 * not33
        p_ulinea_ulineb = (
            eye4[None, None] / bnorm[..., None]
            - torch.einsum("tni,tnj->tnij", uline_b, uline_b) @ eye_t
            / (bnorm[..., None] ** 3))
        if use_left:
            cc = se3.circled_circ(yyw)
            p_ulineb_p_oxi = torch.einsum("kj,tnqk->tnjq", wTo, cc)
            p_ulineb_p_cxi = p_ulineb_p_oxi
        else:
            cc = se3.circled_circ(torch.einsum("kj,tnj->tnk", wTo.T, yyw))
            p_ulineb_p_oxi = cc.transpose(-1, -2)
            ccp = se3.circled_circ(yyw_prime)
            # wTo^T cTw^T cc^T (ObjectResJacCam.cpp:466)
            p_ulineb_p_cxi = torch.einsum("kj,tlk,tnql->tnjq", wTo, cTw, ccp)
        dd = torch.einsum("tnk,tnkj->tnj", p_be_p_ulinea, p_ulinea_ulineb)
        J_pose = torch.einsum("tnj,tnjq->tnq", dd, p_ulineb_p_oxi)
        J_cam = -torch.einsum("tnj,tnjq->tnq", dd, p_ulineb_p_cxi)
        # a deliberate deviation, as the JAX package's: the reference
        # (ObjectLM.cpp:605) leaves out the -sign(bh) factor of the true
        # derivative of e wrt the semi-axes
        J_shape = -sign * (shape[None, None, :] * b * b) / (bnorm * sqrt_bU2b)

    m = zb_mask[:, None, None]
    return (torch.where(m, J_pose, 0.0), torch.where(m, J_shape, 0.0),
            torch.where(m, J_cam, 0.0))


# --- the regularizers --------------------------------------------------------

def deform_residual(kps_o, kps_mean, frame_mask):
    """r[t, k] = kps[k] - mean[k] on each observed frame. Ref:
    ObjectLM.h:463."""
    r = (kps_o - kps_mean)[None].expand(frame_mask.shape[0], -1, -1)
    return torch.where(frame_mask[:, None, None], r, 0.0)


def shape_residual(shape, shape_mean, frame_mask):
    """r[t] = shape - mean on each observed frame. Ref: ObjectLM.h:498."""
    r = (shape - shape_mean)[None].expand(frame_mask.shape[0], -1)
    return torch.where(frame_mask[:, None], r, 0.0)


# --- Huber, on the stacked raw residual as the reference applies it ----------

def huber_apply(x, eps: float):
    """fvec map (ObjectLM.cpp:823): x if x < eps^2 else 2 eps sqrt(x) -
    eps^2."""
    if math.isinf(eps):
        return x
    k2 = eps * eps
    return torch.where(x < k2, x,
                       2.0 * eps * torch.sqrt(torch.clamp(x, min=1e-18)) - k2)


def huber_jac_scale(x, eps: float):
    """Row scale of the Jacobian (ObjectLM.cpp:845)."""
    if math.isinf(eps):
        return torch.ones_like(x)
    k2 = eps * eps
    return torch.where(x < k2, 1.0,
                       eps / torch.sqrt(torch.clamp(x, min=1e-18)))
