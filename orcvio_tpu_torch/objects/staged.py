"""The staged object pipeline: VIO, SORT, ingest, init and LM, and the
object EKF update over a sequence whose detections live on the device.

Counterpart of ``orcvio_tpu/objects/staged.py``, which compiles the whole
frame (vio_step -> SORT -> keypoint ingest -> at most ``finalize_budget``
finalizations (triangulation, Kabsch, object LM) -> map insert or merge
-> object-residual EKF update) into one ``lax.scan``, its finalizations in
a ``lax.while_loop`` over a carried "pending" mask. Here the frame is a
Python step over device tensors, and the while loop's condition is read on
the host: ``pending.any()`` once a frame (and once more after each
finalization while the budget lasts), so the heavy finalize body runs only
on the frames that need it. That read is the replay's one host read a
frame once the filter runs (``vio_step`` reads the init flag only while it
is false).

Ref: System.cpp:622-709 and ObjectInitNode.cpp:408-1219 (the blocking
service round trip becomes a value dependency inside the frame).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..filter.pipeline import FrameInput, build_chi2_table
from ..filter.state import put, take
from ..tree import Tree, tree_where
from ..vio import VioState, vio_step
from .init import _combos
from .manager import (ObjectTable, PoseHistory, finalize_object, free_rows,
                      ingest, rows_to_finalize)
from .sort import SortState, sort_step
from .update import object_ekf_update
from .vio_objects import ObjectVioConfig, associate, camera_pose


@dataclasses.dataclass
class MapTable(Tree):
    """Fixed-capacity object map with insert-or-merge semantics."""

    wTo: torch.Tensor  # (Mc, 4, 4)
    shape: torch.Tensor  # (Mc, 3)
    kps_world: torch.Tensor  # (Mc, K, 3)
    class_id: torch.Tensor  # (Mc,) int32
    n_obs: torch.Tensor  # (Mc,) int32 frames of the winning track
    n_tracks: torch.Tensor  # (Mc,) int32 merged tracks
    lm_cost: torch.Tensor  # (Mc,)
    valid: torch.Tensor  # (Mc,)

    @classmethod
    def create(cls, capacity: int, n_kps: int, dtype=torch.float32,
               device=None):
        def z(shape, dt=dtype, v=0):
            return torch.full(shape, v, dtype=dt, device=device)

        return cls(
            wTo=torch.eye(4, dtype=dtype, device=device).repeat(capacity, 1,
                                                                1),
            shape=z((capacity, 3)), kps_world=z((capacity, n_kps, 3)),
            class_id=z((capacity,), torch.int32, -1),
            n_obs=z((capacity,), torch.int32),
            n_tracks=z((capacity,), torch.int32), lm_cost=z((capacity,)),
            valid=z((capacity,), torch.bool))


def map_insert(mt: MapTable, wTo, shape, kps_world, class_id, n_obs, lm_cost,
               do_insert, merge_distance: float):
    """Insert or merge one finalized object: the association of
    ``ObjectVio._merge_key``, on the device."""
    d = torch.linalg.norm(mt.wTo[:, :3, 3] - wTo[:3, 3][None, :], dim=1)
    d = torch.where(mt.valid & (mt.class_id == class_id), d, torch.inf)
    near = torch.argmin(d)
    merged = take(d, near) < merge_distance
    free_row = torch.argmin(mt.valid.to(torch.uint8))  # first free, else 0
    row = torch.where(merged, near, free_row)
    do = do_insert & ~(torch.all(mt.valid) & ~merged)
    # on a merge, keep the estimate of the track that saw more frames
    replace = do & (~merged | (n_obs >= take(mt.n_obs, row)))

    def upd(field, new, cond=replace):
        return put(field, row, torch.where(cond, new, take(field, row)))

    return mt.replace(
        wTo=upd(mt.wTo, wTo), shape=upd(mt.shape, shape),
        kps_world=upd(mt.kps_world, kps_world),
        class_id=upd(mt.class_id, class_id, do),
        n_obs=upd(mt.n_obs, n_obs), lm_cost=upd(mt.lm_cost, lm_cost),
        n_tracks=upd(mt.n_tracks, take(mt.n_tracks, row) + 1, do),
        valid=upd(mt.valid, torch.ones_like(mt.valid[0]), do))


@dataclasses.dataclass
class ObjectsCarry(Tree):
    vio: VioState
    sort: SortState
    table: ObjectTable
    poses: PoseHistory
    pending: torch.Tensor  # (O,) rows waiting to be finalized
    omap: MapTable


class ObjectsStream(NamedTuple):
    """The detections of every frame, (T, ...) tensors on the device."""

    boxes: torch.Tensor  # (T, M, 4) normalized bboxes
    classes: torch.Tensor  # (T, M) int32
    kps: torch.Tensor  # (T, M, K, 2)
    kps_mask: torch.Tensor  # (T, M, K)
    valid: torch.Tensor  # (T, M)


def make_objects_replay(ocfg: ObjectVioConfig, max_obs: int,
                        map_capacity: int = 32, dtype=torch.float32,
                        device=None):
    """replay(carry, frames, stream) -> (carry, outs): the frames (T, ...)
    and their detections in order. ``replay.init_carry(vio_state)`` gives
    the starting carry. outs: {"p" (T, 3), "R" (T, 3, 3), "n_map" (T,)}."""
    device = resolve_device(device)
    no_tf32()
    fcfg = ocfg.filter
    mc = ocfg.manager
    chi2 = build_chi2_table(fcfg, dtype, device)
    kps_mean = torch.as_tensor(np.asarray(ocfg.kps_mean), dtype=dtype,
                               device=device)
    shape_mean = torch.as_tensor(np.asarray(ocfg.shape_mean), dtype=dtype,
                                 device=device)
    _combos(mc.n_kps, kps_mean.device)  # RANSAC's triples, made here once
    window = torch.arange(mc.window, device=device)
    rows = torch.arange(mc.capacity, device=device)
    merge_distance = ocfg.merge_distance if ocfg.merge_duplicates else 1e-6
    budget = max(1, int(ocfg.finalize_budget))

    def init_carry(vio_state: VioState) -> ObjectsCarry:
        return ObjectsCarry(
            vio=vio_state, sort=SortState.create(ocfg.sort, dtype, device),
            table=ObjectTable.create(mc, dtype, device),
            poses=PoseHistory.create(mc.pose_history, dtype, device),
            pending=torch.zeros(mc.capacity, dtype=torch.bool, device=device),
            omap=MapTable.create(map_capacity, mc.n_kps, dtype, device))

    def finalize(vio, table, poses, omap, pending):
        r = torch.argmax(pending.to(torch.uint8))
        fin, exp, wTc_obj, _ = finalize_object(
            fcfg, ocfg.lm, take(table.zs, r), take(table.zs_mask, r),
            take(table.zb, r), take(table.zb_mask, r), take(table.t, r),
            window < take(table.n, r), poses, kps_mean, shape_mean,
            use_ransac=ocfg.use_ransac)
        omap = map_insert(omap, fin.wTo, fin.shape, fin.kps_world,
                          take(table.class_id, r), take(table.n, r),
                          fin.lm_cost, fin.ok, merge_distance)
        if ocfg.use_object_residual_update:
            new_fs, used, _ = object_ekf_update(fcfg, vio.filter, exp,
                                                wTc_obj, take(table.t, r),
                                                chi2)
            vio = vio.replace(filter=tree_where(used & fin.ok, new_fs,
                                                vio.filter))
        kill = rows == r
        return vio, free_rows(table, kill), omap, pending & ~kill

    def step(carry: ObjectsCarry, frame: FrameInput, det):
        vio, out = vio_step(fcfg, carry.vio, frame, chi2)
        fs = vio.filter
        t = fs.t.to(dtype)
        poses = carry.poses.push(camera_pose(fs), t)
        sort, sout = sort_step(ocfg.sort, carry.sort, det.boxes, det.classes,
                               det.valid)
        kps, kps_mask, has_det = associate(sout, det.boxes, det.valid,
                                           det.kps, det.kps_mask)
        table = ingest(mc, carry.table, t,
                       torch.where(has_det, sout.track_id, -1),
                       sout.class_id, sout.bboxes, kps, kps_mask, has_det)
        fin_mask, junk_mask = rows_to_finalize(mc, table, sout.lost_id)
        # junk rows are freed every frame; then at most `budget` pending
        # rows are finalized, each only while one is pending (a host read)
        table = free_rows(table, junk_mask)
        pending = (carry.pending | fin_mask) & (table.oid >= 0) & ~junk_mask
        omap = carry.omap
        for _ in range(budget):
            if not bool(pending.any()):
                break
            vio, table, omap, pending = finalize(vio, table, poses, omap,
                                                 pending)
        return ObjectsCarry(vio=vio, sort=sort, table=table, poses=poses,
                            pending=pending, omap=omap), out, omap.valid.sum()

    def replay(carry: ObjectsCarry, frames: FrameInput, stream: ObjectsStream):
        ps, Rs, n_map = [], [], []
        for k in range(frames.t.shape[0]):
            carry, out, n = step(carry, FrameInput(*(x[k] for x in frames)),
                                 ObjectsStream(*(x[k] for x in stream)))
            ps.append(out.p)
            Rs.append(out.R)
            n_map.append(n)
        return carry, {"p": torch.stack(ps), "R": torch.stack(Rs),
                       "n_map": torch.stack(n_map)}

    replay.init_carry = init_carry
    return replay
