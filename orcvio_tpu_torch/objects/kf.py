"""Batched linear Kalman filters: keypoint smoothing and SORT's boxes.

Counterpart of ``orcvio_tpu/objects/kf.py``: the reference's constant-
velocity keypoint KF (``src/feat/kf.cpp``: [x, y, vx, vy], noise_ax =
noise_ay = 9, R = 0.0225 I) and SORT's 7-state box KF
(``ros_wrapper/src/sort_ros/src/KalmanTracker.cpp``: [cx, cy, area, ratio,
vcx, vcy, varea], Q = R = 1e-2 I), over any leading batch dimensions.
The small inverses are ``inv_ex``: no host read of an error flag.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import Tree


@dataclasses.dataclass
class Kf4State(Tree):
    x: torch.Tensor  # (..., 4) [x, y, vx, vy]
    P: torch.Tensor  # (..., 4, 4)
    t: torch.Tensor  # (...,) last update time
    init: torch.Tensor  # (...,) bool


def kf4_create(batch, dtype=torch.float32, device=None):
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Kf4State(x=z(batch + (4,)), P=z(batch + (4, 4)), t=z(batch),
                    init=z(batch, torch.bool))


_P0_POS, _P0_VEL = 1.0, 1000.0  # the initial covariance's diagonal
_V_INIT = 3.0 / 0.1  # kf.cpp:74
_NOISE_A = 9.0
_R_KP = 0.0225


def _inv(S):
    return torch.linalg.inv_ex(S)[0]


def kf4_step(s: Kf4State, z, t, meas_valid):
    """Predict and update with z (..., 2) at time t (...,). Tracks not yet
    initialized start from the measurement (kf.cpp:62-81); invalid
    measurements leave the state as it is."""
    dtype, dev = s.x.dtype, s.x.device
    dt = t - s.t
    x_pred = torch.cat([s.x[..., 0:2] + dt[..., None] * s.x[..., 2:4],
                        s.x[..., 2:4]], dim=-1)
    zero, one = torch.zeros_like(dt), torch.ones_like(dt)
    F = torch.stack([torch.stack([one, zero, dt, zero], -1),
                     torch.stack([zero, one, zero, dt], -1),
                     torch.stack([zero, zero, one, zero], -1),
                     torch.stack([zero, zero, zero, one], -1)], dim=-2)
    dt2 = dt * dt
    q4 = dt2 * dt2 / 4 * _NOISE_A
    q3 = dt2 * dt / 2 * _NOISE_A
    q2 = dt2 * _NOISE_A
    Q = torch.stack([torch.stack([q4, zero, q3, zero], -1),
                     torch.stack([zero, q4, zero, q3], -1),
                     torch.stack([q3, zero, q2, zero], -1),
                     torch.stack([zero, q3, zero, q2], -1)], dim=-2)
    P_pred = F @ s.P @ F.transpose(-1, -2) + Q

    # update, H = [I2 0]
    y = z - x_pred[..., 0:2]
    S = P_pred[..., 0:2, 0:2] + _R_KP * torch.eye(2, dtype=dtype, device=dev)
    K = P_pred[..., :, 0:2] @ _inv(S)
    x_new = x_pred + torch.einsum("...ij,...j->...i", K, y)
    P_new = P_pred - K @ P_pred[..., 0:2, :]

    # initialization from the measurement
    x0 = torch.cat([z, torch.full_like(z, _V_INIT)], dim=-1)
    P0 = torch.diag(torch.cat([torch.full((2,), v, dtype=dtype, device=dev)
                               for v in (_P0_POS, _P0_VEL)])).expand(s.P.shape)

    upd = meas_valid
    both = upd & s.init
    x = torch.where(both[..., None], x_new,
                    torch.where(upd[..., None], x0, s.x))
    P = torch.where(both[..., None, None], P_new,
                    torch.where(upd[..., None, None], P0, s.P))
    return Kf4State(x=x, P=P, t=torch.where(upd, t, s.t), init=s.init | upd)


def kf4_position(s: Kf4State):
    return s.x[..., 0:2]


# --- SORT's 7-state box KF: [cx, cy, area, ratio, vcx, vcy, varea] ----------

@dataclasses.dataclass
class Kf7State(Tree):
    x: torch.Tensor  # (..., 7)
    P: torch.Tensor  # (..., 7, 7)


_Q7 = 1e-2
_R7 = 1e-2


def _f7(dtype, device):
    F = torch.eye(7, dtype=dtype, device=device)
    return F + torch.eye(7, dtype=dtype, device=device).roll(4, dims=1) * \
        (torch.arange(7, device=device) < 3)[:, None]


def bbox_to_z(bbox):
    """xmin, ymin, xmax, ymax -> cx, cy, area, ratio
    (KalmanTracker.cpp:37-40)."""
    w = bbox[..., 2] - bbox[..., 0]
    h = torch.clamp(bbox[..., 3] - bbox[..., 1], min=1e-6)
    return torch.stack([bbox[..., 0] + w / 2, bbox[..., 1] + h / 2, w * h,
                        w / h], dim=-1)


def z_to_bbox(z):
    w = torch.sqrt(torch.clamp(z[..., 2] * z[..., 3], min=1e-12))
    h = torch.clamp(z[..., 2], min=1e-12) / w
    return torch.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                        z[..., 0] + w / 2, z[..., 1] + h / 2], dim=-1)


def kf7_init(bbox):
    z = bbox_to_z(bbox)
    x = torch.cat([z, torch.zeros_like(z[..., :3])], dim=-1)
    P = torch.eye(7, dtype=x.dtype, device=x.device).expand(x.shape + (7,))
    return Kf7State(x=x, P=P)


def kf7_predict(s: Kf7State):
    F = _f7(s.x.dtype, s.x.device)
    return Kf7State(
        x=torch.einsum("ij,...j->...i", F, s.x),
        P=F @ s.P @ F.T + _Q7 * torch.eye(7, dtype=s.x.dtype,
                                          device=s.x.device))


def kf7_update(s: Kf7State, bbox, valid):
    y = bbox_to_z(bbox) - s.x[..., :4]
    S = s.P[..., :4, :4] + _R7 * torch.eye(4, dtype=s.x.dtype,
                                          device=s.x.device)
    K = s.P[..., :, :4] @ _inv(S)
    x_new = s.x + torch.einsum("...ij,...j->...i", K, y)
    P_new = s.P - K @ s.P[..., :4, :]
    return Kf7State(x=torch.where(valid[..., None], x_new, s.x),
                    P=torch.where(valid[..., None, None], P_new, s.P))
