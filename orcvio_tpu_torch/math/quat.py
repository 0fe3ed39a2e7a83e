"""Hamilton quaternions, [x, y, z, w] layout, batched.

Counterpart of ``orcvio_tpu/math/quat.py`` (reference:
math_utils.hpp:68-226): what the filter uses. ``from_rotation`` is
Shepperd's method with the four candidates computed and one picked by the
largest pivot, as in the JAX package.
"""
from __future__ import annotations

import torch


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def multiply(q1, q2):
    """Hamilton product q1 * q2, (..., 4) in [x,y,z,w]. Ref: math_utils.hpp:80."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    q = torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)
    return normalize(q)


def inverse(q):
    """Conjugate of a unit quaternion. Ref: math_utils.hpp:278."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def to_rotation(q):
    """Unit quaternion -> rotation matrix (Hamilton). Ref: math_utils.hpp:162."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def from_rotation(R):
    """Rotation matrix -> unit quaternion [x,y,z,w], w >= 0.
    Ref: math_utils.hpp:192."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qx0 = safe_sqrt(1.0 + 2.0 * r00 - tr) * 0.5
    c0 = torch.stack([qx0, (r01 + r10) / (4 * qx0), (r02 + r20) / (4 * qx0),
                      (r21 - r12) / (4 * qx0)], -1)
    qy1 = safe_sqrt(1.0 + 2.0 * r11 - tr) * 0.5
    c1 = torch.stack([(r01 + r10) / (4 * qy1), qy1, (r12 + r21) / (4 * qy1),
                      (r02 - r20) / (4 * qy1)], -1)
    qz2 = safe_sqrt(1.0 + 2.0 * r22 - tr) * 0.5
    c2 = torch.stack([(r02 + r20) / (4 * qz2), (r12 + r21) / (4 * qz2), qz2,
                      (r10 - r01) / (4 * qz2)], -1)
    qw3 = safe_sqrt(1.0 + tr) * 0.5
    c3 = torch.stack([(r21 - r12) / (4 * qw3), (r02 - r20) / (4 * qw3),
                      (r10 - r01) / (4 * qw3), qw3], -1)
    k = torch.argmax(torch.stack([r00, r11, r22, tr], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(cands, k[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return normalize(q)
