"""Object observation manager: accumulation, smoothing, finalization.

Counterpart of ``orcvio_tpu/objects/manager.py`` (reference: the ROS
``ObjectInitNode``, ros_wrapper/src/orcvio/src/ObjectInitNode.cpp:
``callback_sem`` :408, which accumulates each object's keypoints and bbox
with a KF per keypoint and declares objects lost, ``callback_pose`` :365,
the camera pose history, and ``do_object_feature_initialization`` :1037,
which triangulates, fits Kabsch, runs the object LM and exports for the
EKF on lost objects). The ROS plumbing becomes trees of tensors with fixed
capacities; finalization is one function of an object's window.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..filter.state import put, set_rows, take
from ..math import se3
from ..tree import Tree, tree_map
from .init import (_svd, first_index, object_initialization,
                   object_initialization_lite)
from .kf import Kf4State, kf4_create, kf4_position, kf4_step
from .lm import (ObjectLMConfig, ObjectLMData, ObjectLMState,
                 export_for_update, optimize)


class ManagerConfig(NamedTuple):
    capacity: int = 8  # objects at once
    window: int = 32  # frames kept per object
    n_kps: int = 12  # keypoints of the class (car: 12)
    pose_history: int = 128  # camera pose ring buffer
    min_frames: int = 8  # min_object_feature_track_length
    smooth_keypoints: bool = True


@dataclasses.dataclass
class PoseHistory(Tree):
    """Ring buffer of camera poses (callback_pose, ObjectInitNode.cpp:365)."""

    wTc: torch.Tensor  # (H, 4, 4)
    t: torch.Tensor  # (H,)
    valid: torch.Tensor  # (H,)
    head: torch.Tensor  # () int32 next write slot

    @classmethod
    def create(cls, cap: int, dtype=torch.float32, device=None):
        return cls(
            wTc=torch.eye(4, dtype=dtype, device=device).repeat(cap, 1, 1),
            t=torch.full((cap,), -1.0, dtype=dtype, device=device),
            valid=torch.zeros(cap, dtype=torch.bool, device=device),
            head=torch.zeros((), dtype=torch.int32, device=device))

    def push(self, wTc, t):
        i = self.head % self.t.shape[0]
        return self.replace(wTc=put(self.wTc, i, wTc), t=put(self.t, i, t),
                            valid=put(self.valid, i, torch.ones_like(
                                self.valid[0])),
                            head=self.head + 1)

    def lookup(self, times, tol=1e-6):
        """times (T,) -> (wTc (T, 4, 4), found (T,))."""
        d = torch.abs(times[:, None] - self.t[None, :])
        d = torch.where(self.valid[None, :], d, torch.inf)
        return self.wTc[torch.argmin(d, dim=1)], torch.amin(d, dim=1) < tol


@dataclasses.dataclass
class ObjectTable(Tree):
    """Fixed-capacity observation windows per object (ObjectFeature.h:31)."""

    oid: torch.Tensor  # (O,) int32 external track id, -1 free
    class_id: torch.Tensor  # (O,) int32
    zs: torch.Tensor  # (O, TW, K, 2)
    zs_mask: torch.Tensor  # (O, TW, K)
    zb: torch.Tensor  # (O, TW, 4)
    zb_mask: torch.Tensor  # (O, TW)
    t: torch.Tensor  # (O, TW)
    n: torch.Tensor  # (O,) int32 frames filled
    kp_kf: Kf4State  # batched (O, K)

    @classmethod
    def create(cls, mc: ManagerConfig, dtype=torch.float32, device=None):
        O, TW, K = mc.capacity, mc.window, mc.n_kps

        def z(shape, dt=dtype, v=0):
            return torch.full(shape, v, dtype=dt, device=device)

        return cls(oid=z((O,), torch.int32, -1),
                   class_id=z((O,), torch.int32, -1),
                   zs=z((O, TW, K, 2)), zs_mask=z((O, TW, K), torch.bool),
                   zb=z((O, TW, 4)), zb_mask=z((O, TW), torch.bool),
                   t=z((O, TW)), n=z((O,), torch.int32),
                   kp_kf=kf4_create((O, K), dtype, device))


def ingest(mc: ManagerConfig, table: ObjectTable, t, obj_ids, class_ids,
           bboxes, kps, kps_mask, det_valid):
    """Accumulate one frame of tracked detections: obj_ids (M,) SORT track
    ids, bboxes (M, 4), kps (M, K, 2) semantic keypoints (kps_mask (M, K)).
    Ref: callback_sem (ObjectInitNode.cpp:408)."""
    O = table.oid.shape[0]
    M = obj_ids.shape[0]
    dev = obj_ids.device
    det_valid = det_valid & (obj_ids >= 0)

    live = table.oid >= 0
    eq = ((obj_ids[:, None] == table.oid[None, :]) & det_valid[:, None]
          & live[None, :])
    matched = torch.any(eq, dim=1)
    row_of = torch.argmax(eq.to(torch.uint8), dim=1)

    is_new = det_valid & ~matched
    free = ~live
    free_rank = torch.cumsum(free, 0) - 1
    new_rank = torch.cumsum(is_new, 0) - 1
    can = is_new & (new_rank < free.sum())
    rank_to_row = set_rows(torch.zeros(O, dtype=torch.int64, device=dev),
                           torch.where(free, free_rank, O),
                           torch.arange(O, device=dev))
    row = torch.where(matched, row_of,
                      rank_to_row[torch.clamp(new_rank, 0, O - 1)])
    write = matched | can
    rows = torch.where(write, row, O)
    row_c = torch.clamp(row, 0, O - 1)

    # the column is the object's fill count (clamped: a full window stops
    # accumulating; the manager should have finalized it already)
    col = torch.clamp(table.n[row_c], 0, mc.window - 1).long()

    # keypoint KF smoothing per (object, keypoint) (ObjectFeature.h:46)
    kf_sel = tree_map(lambda a: a[row_c], table.kp_kf)
    t_b = t.expand(M, mc.n_kps)
    kf_new = kf4_step(kf_sel, kps, t_b, kps_mask & write[:, None])
    kps_out = kf4_position(kf_new) if mc.smooth_keypoints else kps
    kps_out = torch.where(kps_mask[..., None], kps_out, 0.0)

    def at_rc(base, values):
        return set_rows(base, rows, values, col)

    one = torch.ones(M, dtype=torch.bool, device=dev)
    new_rows = torch.where(can, row, O)
    return table.replace(
        oid=set_rows(table.oid, new_rows, obj_ids.to(torch.int32)),
        class_id=set_rows(table.class_id, new_rows,
                          class_ids.to(torch.int32)),
        zs=at_rc(table.zs, kps_out), zs_mask=at_rc(table.zs_mask, kps_mask),
        zb=at_rc(table.zb, bboxes), zb_mask=at_rc(table.zb_mask, one),
        t=at_rc(table.t, t.expand(M)),
        n=table.n + torch.zeros(O + 1, dtype=torch.int32, device=dev
                                ).index_add(0, rows, write.to(torch.int32)
                                            )[:O],
        kp_kf=tree_map(lambda full, new: set_rows(full, rows, new),
                       table.kp_kf, kf_new))


def rows_to_finalize(mc: ManagerConfig, table: ObjectTable, lost_ids):
    """Rows ready for init and LM (SORT lost them, or their window is full,
    with enough frames) and rows to drop (lost or full with too few).
    Ref: the lost_flag and track-length handling
    (ObjectInitNode.cpp:650-740)."""
    lost = torch.isin(table.oid, lost_ids) & (table.oid >= 0)
    full = table.n >= mc.window
    enough = table.n >= mc.min_frames
    return (lost | full) & enough, (lost | full) & ~enough


def free_rows(table: ObjectTable, kill_mask):
    O = table.oid.shape[0]

    def clear(a):
        k = kill_mask.reshape((O,) + (1,) * (a.dim() - 1))
        return torch.where(k, torch.zeros_like(a), a)

    return table.replace(
        oid=torch.where(kill_mask, -1, table.oid).to(torch.int32),
        n=torch.where(kill_mask, 0, table.n).to(torch.int32),
        zs_mask=table.zs_mask & ~kill_mask[:, None, None],
        zb_mask=table.zb_mask & ~kill_mask[:, None],
        kp_kf=tree_map(clear, table.kp_kf))


class FinalizedObject(NamedTuple):
    wTo: torch.Tensor  # (4, 4)
    shape: torch.Tensor  # (3,)
    kps_world: torch.Tensor  # (K, 3)
    ok: torch.Tensor  # bool
    lm_cost: torch.Tensor


def finalize_object(cfg: FilterConfig, lmc: ObjectLMConfig, zs, zs_mask, zb,
                    zb_mask, frame_t, frame_valid, poses: PoseHistory,
                    kps_mean, shape_mean, use_ransac=True):
    """Triangulation, Kabsch and LM over one object's window: (the
    finalized object, the EKF export, the window's camera poses, the LM's
    data). Ref: do_object_feature_initialization
    (ObjectInitNode.cpp:1037-1219)."""
    wTc, found = poses.lookup(frame_t)
    frame_ok = frame_valid & found
    zs_m = zs_mask & frame_ok[:, None]
    zb_m = zb_mask & frame_ok

    if lmc.lite:
        # bbox-only init from the first valid bbox
        # (single_object_initialization_lite,
        # ObjectFeatureInitializer.cpp:497)
        wTc_f = take(wTc, first_index(zb_m))
        wTo0, init_ok = object_initialization_lite(
            take(zb, first_index(zb_m)), wTc_f[:3, :3].T, wTc_f[:3, 3],
            shape_mean)
        init_ok = init_ok & torch.any(zb_m)
    else:
        wTq, init_ok, _, _ = object_initialization(
            cfg, zs, zs_m, wTc[:, :3, :3], wTc[:, :3, 3], kps_mean,
            use_ransac=use_ransac, zb=zb, zb_mask=zb_m,
            shape_ellipsoid=shape_mean)
        # the nearest rotation to Kabsch's scaled linear part
        U, _, Vt = _svd(wTq[:3, :3])
        wTo0 = se3.make_pose(U @ Vt, wTq[:3, 3])

    st0 = ObjectLMState(wTo=wTo0, shape=shape_mean, kps=kps_mean)
    data = ObjectLMData(cTw=se3.inverse_pose(wTc), zs=zs, zs_mask=zs_m,
                        zb=zb, zb_mask=zb_m, frame_mask=frame_ok,
                        kps_mean=kps_mean, shape_mean=shape_mean)
    st, cost, _ = optimize(lmc, st0, data)
    ok = init_ok & torch.isfinite(cost) & torch.all(torch.isfinite(st.wTo))
    exp = export_for_update(lmc, st, data)
    kps_world = st.kps @ st.wTo[:3, :3].T + st.wTo[:3, 3]
    fin = FinalizedObject(wTo=st.wTo, shape=st.shape, kps_world=kps_world,
                          ok=ok, lm_cost=cost)
    return fin, exp, wTc, data
