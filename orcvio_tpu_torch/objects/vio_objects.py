"""OrcVIO mode: the VIO and object pipeline's host orchestrator.

Counterpart of ``orcvio_tpu/objects/vio_objects.py`` (reference: the two
nodelets, ``ros_wrapper/src/orcvio/src/System.cpp``, VIO with a blocking
object service, and ``ObjectInitNode.cpp``, SORT-fed accumulation, init
and LM). The ROS topics and service become calls; a frame runs
(SURVEY.md §3.4):

    detections -> SORT -> keypoint ingest (a KF per keypoint) -> on a lost
    object: triangulation, Kabsch and the object LM -> the object-residual
    EKF update of the sliding window
    (use_object_residual_update_cam_pose_flag).

The host reads which rows to finalize, and each finalized object's
success and update decision, as the JAX package's orchestrator does; the
staged replay (``objects/staged.py``) is the mode that keeps the card
busy. Detections from the keypoint network (``step_image``) are not part
of the port yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig
from ..filter.augment import cam_poses, current_clone_slot
from ..filter.pipeline import FrameInput, build_chi2_table
from ..filter.state import take
from ..math import se3
from ..vio import VioState, vio_step
from .lm import ObjectLMConfig
from .manager import (ManagerConfig, ObjectTable, PoseHistory,
                      finalize_object, free_rows, ingest, rows_to_finalize)
from .sort import SortConfig, SortState, iou_matrix, sort_step
from .update import object_ekf_update


class ObjectVioConfig(NamedTuple):
    filter: FilterConfig
    lm: ObjectLMConfig
    manager: ManagerConfig
    sort: SortConfig
    kps_mean: tuple  # (K, 3) the class's mean keypoints
    shape_mean: tuple  # (3,)
    use_object_residual_update: bool = True
    use_ransac: bool = True
    # merge re-finalized tracks of one physical object: an estimate whose
    # centre lies within merge_distance of a map entry of its class updates
    # that entry (the reference keys its map by SORT track id, so a car seen
    # again makes a new entry, ObjectInitNode.cpp:986-1035)
    merge_duplicates: bool = False
    merge_distance: float = 2.0
    # the staged replay's finalizations per frame at most (objects/staged.py)
    finalize_budget: int = 1


def associate(sout, det_boxes, det_valid, det_kps, det_kps_mask):
    """Each live track's detection by IoU, for keypoint ingestion (the
    reference's TrackedBBoxListWithKeypoints carries this pairing):
    (kps (C, K, 2), kps_mask (C, K), has_det (C,))."""
    iou = iou_matrix(sout.bboxes, det_boxes)
    best_det = torch.argmax(iou, dim=1)
    has_det = ((torch.amax(iou, dim=1) > 0.1) & (sout.track_id >= 0)
               & det_valid[best_det])
    return (det_kps[best_det], det_kps_mask[best_det] & has_det[:, None],
            has_det)


def camera_pose(fs):
    """wTc (4, 4) of the newest clone's camera (callback_pose)."""
    slot = current_clone_slot(fs)
    R_c2w, t_c_w = cam_poses(fs)
    return se3.make_pose(take(R_c2w, slot), take(t_c_w, slot))


class ObjectVio:
    """The host orchestrator: the stage functions and their states."""

    def __init__(self, cfg: ObjectVioConfig, max_obs: int,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = device = resolve_device(device)
        no_tf32()
        self.vio = VioState.create(cfg.filter, max_obs, dtype, device)
        self.sort = SortState.create(cfg.sort, dtype, device)
        self.table = ObjectTable.create(cfg.manager, dtype, device)
        self.poses = PoseHistory.create(cfg.manager.pose_history, dtype,
                                        device)
        self.chi2 = build_chi2_table(cfg.filter, dtype, device)
        self.kps_mean = torch.as_tensor(np.asarray(cfg.kps_mean), dtype=dtype,
                                        device=device)
        self.shape_mean = torch.as_tensor(np.asarray(cfg.shape_mean),
                                          dtype=dtype, device=device)
        self.object_map: Dict[int, dict] = {}
        # called after every object update tried:
        # hook(oid, fs_before, fs_after, used, diag: UpdateDiag, entry)
        self.update_hook = None

    def set_filter_state(self, filter_state):
        self.vio = self.vio.replace(filter=filter_state,
                                    host_initialized=False)

    def _put(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device, dtype or self.dtype)

    def _merge_key(self, oid: int, entry: dict) -> int:
        """The map key of a finalized estimate: a map entry of its class
        within merge_distance (3-d centre), else its own track id."""
        c_new = entry["wTo"][:3, 3]
        best, best_d = oid, self.cfg.merge_distance
        for k, e in self.object_map.items():
            if e["class_id"] != entry["class_id"]:
                continue
            d = float(np.linalg.norm(e["wTo"][:3, 3] - c_new))
            if d < best_d:
                best, best_d = k, d
        return best

    def _merged(self, oid: int, entry: dict) -> dict:
        """Combined with the entry under the same key: the estimate of more
        frames, the union of the timestamps, the count of merged tracks."""
        old = self.object_map.get(oid)
        if old is None:
            entry["n_tracks"] = 1
            return entry
        keep = entry if len(entry["timestamps"]) >= len(old["timestamps"]) \
            else old
        out = dict(keep)
        out["timestamps"] = sorted(set(old["timestamps"])
                                   | set(entry["timestamps"]))
        out["n_tracks"] = old.get("n_tracks", 1) + 1
        if old.get("ekf_update_applied"):
            out["ekf_update_applied"] = True
        return out

    def step_image(self, frame: FrameInput, img, det_boxes_px, det_classes,
                   det_valid, detector):
        """One camera frame from a RAW image and pixel-space 2D detections:
        the StarMap detector (``objects/detector.py``, which holds the
        camera's intrinsics) on each bbox crop, the reference's darknet ->
        StarMap -> ObjectInitNode chain, then ``step``. Boxes too small for
        keypoints are dropped; truncated ones at the border are kept."""
        b = np.asarray(det_boxes_px, np.float64)
        big_enough = (b[:, 2] - b[:, 0] > 16) & (b[:, 3] - b[:, 1] > 9)
        det_valid = np.asarray(det_valid) & big_enough
        det_kps, det_kps_mask = detector(img, det_boxes_px, det_valid)
        fx, fy, cx, cy = detector.K_cam
        boxes_norm = np.stack([(b[:, 0] - cx) / fx, (b[:, 1] - cy) / fy,
                               (b[:, 2] - cx) / fx, (b[:, 3] - cy) / fy],
                              axis=1)
        return self.step(frame, boxes_norm, det_classes, det_kps,
                         det_kps_mask, det_valid)

    def _finalize(self, zs, zs_mask, zb, zb_mask, ft, fv, poses):
        """``manager.finalize_object`` on one table row's observations (a
        method, so that a caller can wrap it to log the finalizations)."""
        cfg = self.cfg
        return finalize_object(cfg.filter, cfg.lm, zs, zs_mask, zb, zb_mask,
                               ft, fv, poses, self.kps_mean, self.shape_mean,
                               use_ransac=cfg.use_ransac)

    def step(self, frame: FrameInput, det_boxes, det_classes, det_kps,
             det_kps_mask, det_valid):
        """One camera frame with its object detections: det_boxes (M, 4)
        normalized bboxes, det_kps (M, K, 2) semantic keypoints, their
        masks. Returns the frame's FrameOutput."""
        cfg = self.cfg
        fcfg, mc = cfg.filter, cfg.manager
        self.vio, out = vio_step(fcfg, self.vio, frame, self.chi2)
        fs = self.vio.filter
        t = fs.t.to(self.dtype)
        self.poses = self.poses.push(camera_pose(fs), t)

        boxes = self._put(det_boxes)
        valid = self._put(det_valid, torch.bool)
        self.sort, sout = sort_step(cfg.sort, self.sort, boxes,
                                    self._put(det_classes, torch.int32),
                                    valid)
        kps, kps_mask, has_det = associate(
            sout, boxes, valid, self._put(det_kps),
            self._put(det_kps_mask, torch.bool))
        self.table = ingest(mc, self.table, t,
                            torch.where(has_det, sout.track_id, -1),
                            sout.class_id, sout.bboxes, kps, kps_mask,
                            has_det)

        # finalize lost and full objects (do_object_feature_initialization)
        fin_mask, junk_mask = rows_to_finalize(mc, self.table, sout.lost_id)
        arange = torch.arange(mc.window, device=self.device)
        tb = self.table
        for r in torch.nonzero(fin_mask).flatten().tolist():
            fin, exp, wTc_obj, _ = self._finalize(
                tb.zs[r], tb.zs_mask[r], tb.zb[r], tb.zb_mask[r], tb.t[r],
                arange < tb.n[r], self.poses)
            if not bool(fin.ok):
                continue
            oid = int(tb.oid[r])
            n = int(tb.n[r])
            entry = dict(
                wTo=fin.wTo.cpu().numpy(), shape=fin.shape.cpu().numpy(),
                kps_world=fin.kps_world.cpu().numpy(),
                lm_cost=float(fin.lm_cost), class_id=int(tb.class_id[r]),
                timestamps=tb.t[r, :n].cpu().numpy().tolist())
            if cfg.merge_duplicates:
                oid = self._merge_key(oid, entry)
            self.object_map[oid] = self._merged(oid, entry)
            if cfg.use_object_residual_update:
                new_fs, used, diag = object_ekf_update(
                    fcfg, self.vio.filter, exp, wTc_obj, tb.t[r], self.chi2)
                used = bool(used)
                if self.update_hook is not None:
                    self.update_hook(oid, self.vio.filter, new_fs, used, diag,
                                     entry)
                if used:
                    self.vio = self.vio.replace(filter=new_fs)
                    self.object_map[oid]["ekf_update_applied"] = True
        kill = fin_mask | junk_mask
        if bool(torch.any(kill)):
            self.table = free_rows(self.table, kill)
        return out
