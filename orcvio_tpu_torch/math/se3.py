"""SE(3) helpers, batched over leading dimensions.

Counterpart of ``orcvio_tpu/math/se3.py`` (reference: se3_ops.hpp): what
the filter, the dynamic initializer and the object layer use. Twist
convention [rho, phi], translation first (se3_ops.hpp:510).
"""
from __future__ import annotations

import torch

from . import so3


def exp(xi):
    """se(3) twist (..., 6) [rho, phi] -> homogeneous transform (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", so3.left_jacobian(phi), rho)
    return make_pose(so3.exp(phi), t)


def log(T):
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    phi = so3.log(T[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", so3.left_jacobian_inv(phi),
                       T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def inverse_pose(T):
    """Inverse of a rigid transform. Ref: se3_ops.hpp:30-180 (inversePose)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_pose(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def make_pose(R, t):
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., None]], dim=-1)
    # [0 0 0 1], built out of place so that it batches under vmap
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]),
                        torch.ones_like(top[..., :1, 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def odot(ph):
    """odot operator, (..., 4) homogeneous point -> (..., 4, 6):
    [[w I3, -hat(xyz)], [0, 0]]. Ref: se3_ops.hpp:510."""
    w = ph[..., 3]
    eye = torch.eye(3, dtype=ph.dtype, device=ph.device)
    top = torch.cat([w[..., None, None] * eye, -so3.hat(ph[..., :3])], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def circled_circ(ph):
    """circledCirc operator, (..., 4) -> (..., 6, 4): rows 0:3 hold xyz in
    column 3, rows 3:6 -hat(xyz) in columns 0:3. Ref: se3_ops.hpp:230."""
    xyz = ph[..., :3]
    top = torch.cat([torch.zeros_like(xyz)[..., None, :].expand(
        xyz.shape[:-1] + (3, 3)), xyz[..., :, None]], dim=-1)
    bottom = torch.cat([-so3.hat(xyz), torch.zeros_like(xyz)[..., :, None]],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose_se3_to_se2(T):
    """Flatten an SE(3) pose to SE(2): keep the yaw atan2(r10, r00), zero
    z. Ref: se3_ops.hpp:272 (whose M_PI / atan2 contradicts its own
    comment; this is the standard extraction, as the JAX package's)."""
    yaw = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    yaw = torch.where(torch.isfinite(yaw), yaw, 0.0)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                     torch.stack([z, z, one], -1)], dim=-2)
    return make_pose(R, torch.stack([T[..., 0, 3], T[..., 1, 3], z], dim=-1))


def project_image(x):
    """Perspective division: (..., 3) or (..., 4) -> (..., 2). Ref:
    se3_ops.hpp:304."""
    return x[..., :2] / x[..., 2:3]


def project_image_df(x):
    """Jacobian of perspective division wrt the 3D point, (..., 3) ->
    (..., 2, 3). Ref: se3_ops.hpp:331."""
    z = x[..., 2]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([inv_z, zero, -x[..., 0] * inv_z2], -1),
        torch.stack([zero, inv_z, -x[..., 1] * inv_z2], -1),
    ], dim=-2)


def to_homogeneous(pts):
    """(..., 3) -> (..., 4)."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def project_object_points(P, wTo, points_o):
    """Project homogeneous object-frame points. Ref: se3_ops.hpp:351.
    P (..., 3, 4) camera projection, wTo (..., 4, 4), points_o (..., N, 4)
    -> (..., N, 2)."""
    return project_image(torch.einsum("...ij,...kj->...ki", P @ wTo,
                                      points_o))


def project_object_points_df_object(P, wTo, points_o,
                                    use_left_perturbation: bool):
    """d(projection)/d(object pose twist), (..., N, 2, 6). Ref:
    se3_ops.hpp:383. Left: dpi P odot(wTo p); right: dpi P wTo odot(p)."""
    pts_w = torch.einsum("...ij,...kj->...ki", wTo, points_o)
    dpi = project_image_df(torch.einsum("...ij,...kj->...ki", P, pts_w))
    if use_left_perturbation:
        J = torch.einsum("...ij,...kjl->...kil", P, odot(pts_w))
    else:
        J = torch.einsum("...ij,...kjl->...kil", P @ wTo, odot(points_o))
    return dpi @ J


def project_object_points_df_camera(P, wTo, cTw, points_o,
                                    use_left_perturbation: bool):
    """d(projection)/d(camera pose twist), (..., N, 2, 6). Ref:
    se3_ops.hpp:431. Left: -dpi [I|0] cTw odot(wTo p); right:
    -dpi [I|0] odot(cTw wTo p)."""
    pts_w = torch.einsum("...ij,...kj->...ki", wTo, points_o)
    dpi = project_image_df(torch.einsum("...ij,...kj->...ki", P, pts_w))
    if use_left_perturbation:
        J = torch.einsum("...ij,...kjl->...kil", cTw[..., :3, :],
                         odot(pts_w))
    else:
        pts_cam4 = torch.einsum("...ij,...kj->...ki", cTw, pts_w)
        J = odot(pts_cam4)[..., :3, :]
    return -(dpi @ J)


def get_cam_wrt_imu_se3_jacobian(R_b2c, t_c_b, R_w2c, t_b_w,
                                 use_left_perturbation: bool):
    """(..., 6, 6) d(camera twist) / d(imu clone error). Ref:
    se3_ops.hpp:531.

    Maps the clone error e = [dtheta, dp] (p' = p + dp; R' = exp(dtheta) R
    for the left flag, R exp(dtheta) for the right) to the camera twist
    xi_c = [rho, phi] with wTc' = exp(xi_c) wTc (left) or wTc exp(xi_c)
    (right), wTc = wTi iTc. Inputs broadcast over their leading dims."""
    batch = torch.broadcast_shapes(R_b2c.shape[:-2], t_c_b.shape[:-1],
                                   R_w2c.shape[:-2], t_b_w.shape[:-1])
    eye = torch.eye(3, dtype=R_w2c.dtype, device=R_w2c.device).expand(
        batch + (3, 3))
    if use_left_perturbation:
        top = [so3.hat(t_b_w).expand(batch + (3, 3)), eye]
        bottom = [eye, torch.zeros_like(eye)]
    else:
        top = [(-R_b2c @ so3.hat(t_c_b)).expand(batch + (3, 3)),
               R_w2c.expand(batch + (3, 3))]
        bottom = [R_b2c.expand(batch + (3, 3)), torch.zeros_like(eye)]
    return torch.cat([torch.cat(top, dim=-1), torch.cat(bottom, dim=-1)],
                     dim=-2)


def displacement(T1, T2):
    """((3 - tr(R1^T R2)) / 2, |t1 - t2|). Ref: se3_ops.hpp (displacement)."""
    R1, R2 = T1[..., :3, :3], T2[..., :3, :3]
    disp_r = (3.0 - torch.diagonal(R1.transpose(-1, -2) @ R2, dim1=-2,
                                   dim2=-1).sum(-1)) / 2.0
    return disp_r, torch.linalg.norm(T1[..., :3, 3] - T2[..., :3, 3], dim=-1)
