"""Static (inclinometer) initializer.

Counterpart of ``orcvio_tpu/init/static_init.py`` (reference:
StaticInitializer.cpp:20-135): count consecutive frames whose
outlier-trimmed feature motion stays under a threshold; once
``static_image_num`` is reached, the gyro bias is the mean angular rate and
the orientation aligns the mean specific force with gravity.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..config.core import FilterConfig
from ..filter.state import ImuState
from ..tree import Tree
from ..math import so3


@dataclasses.dataclass
class StaticInitState(Tree):
    counter: torch.Tensor  # consecutive static frames (int32)
    started: torch.Tensor  # bool, reference frame captured
    ref_fid: torch.Tensor  # (M,) int32
    ref_uv: torch.Tensor  # (M, 2)
    sum_gyro: torch.Tensor  # (3,) accumulated raw gyro since start
    sum_acc: torch.Tensor  # (3,)
    n_imu: torch.Tensor  # int32
    done: torch.Tensor  # bool

    @classmethod
    def create(cls, max_obs: int, dtype=torch.float32, device=None):
        device = resolve_device(device)

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(counter=z((), torch.int32), started=z((), torch.bool),
                   ref_fid=torch.full((max_obs,), -1, dtype=torch.int32,
                                      device=device),
                   ref_uv=z((max_obs, 2), dtype), sum_gyro=z(3, dtype),
                   sum_acc=z(3, dtype), n_imu=z((), torch.int32),
                   done=z((), torch.bool))


def static_init_step(cfg: FilterConfig, s: StaticInitState, fids, uvs,
                     meas_mask, imu_gyro, imu_acc, imu_mask) -> StaticInitState:
    """One frame of the static-init state machine. Ref: tryIncInit
    (StaticInitializer.cpp:20)."""
    M = fids.shape[0]
    add = imu_mask[:, None].to(s.sum_gyro.dtype)
    sum_gyro = s.sum_gyro + torch.sum(imu_gyro * add, dim=0)
    sum_acc = s.sum_acc + torch.sum(imu_acc * add, dim=0)
    n_imu = s.n_imu + torch.sum(imu_mask).to(torch.int32)

    valid = meas_mask & (fids >= 0)
    eq = (fids[:, None] == s.ref_fid[None, :]) & valid[:, None] & (s.ref_fid >= 0)[None, :]
    matched = torch.any(eq, dim=1)
    ref_row = torch.argmax(eq.to(torch.int8), dim=1)
    d = torch.linalg.norm(uvs - s.ref_uv[ref_row], dim=1)
    d = torch.where(matched, d, -1.0)  # unmatched sort first
    n_match = torch.sum(matched)

    # "ignore outliers rudely": the k-th largest distance (:44-50)
    k = min(max(M - 1 - cfg.static_outlier_ignore, 0), M - 1)
    max_dis = torch.sort(d).values[k]

    is_static = (n_match >= cfg.static_min_matches) & (max_dis < cfg.zupt_max_feature_dis)
    not_started = ~s.started
    zero = torch.zeros_like(s.counter)
    counter = torch.where(not_started, zero,
                          torch.where(is_static, s.counter + 1, zero))
    take_ref = not_started | is_static
    ref_fid = torch.where(take_ref, torch.where(valid, fids, -1), s.ref_fid)
    ref_uv = torch.where(take_ref, uvs, s.ref_uv)
    done = s.done | (counter >= cfg.static_image_num)
    return s.replace(counter=counter, started=torch.ones_like(s.started),
                     ref_fid=ref_fid, ref_uv=ref_uv, sum_gyro=sum_gyro,
                     sum_acc=sum_acc, n_imu=n_imu, done=done)


def initial_imu_state(cfg: FilterConfig, s: StaticInitState,
                      dtype=torch.float32) -> ImuState:
    """Gravity-aligned initial state. Ref: initializeGravityAndBias
    (StaticInitializer.cpp:77-135)."""
    n = torch.clamp(s.n_imu, min=1).to(s.sum_gyro.dtype)
    gyro_bias = s.sum_gyro / n
    gravity_imu = s.sum_acc / n
    g_norm = torch.linalg.norm(gravity_imu)
    a = gravity_imu / torch.clamp(g_norm, min=1e-9)
    zero, one = torch.zeros_like(a[:1]), torch.ones_like(a[:1])
    b = torch.cat([zero, zero, one])
    v = torch.linalg.cross(a, b)
    c = torch.dot(a, b)
    vn = torch.linalg.norm(v)
    x_axis = torch.cat([one, zero, zero])
    axis = torch.where(vn > 1e-9, v / torch.clamp(vn, min=1e-9), x_axis)
    R = so3.exp(axis * torch.atan2(vn, c))
    z = torch.zeros(3, dtype=dtype, device=a.device)
    return ImuState(R=R.to(dtype), v=z, p=z, bg=gyro_bias.to(dtype), ba=z)
