"""KITTI object-mapping evaluation: loaders, the per-sequence protocol and
the PR table.

Counterpart of ``orcvio_tpu/eval/kitti_objects.py``, itself a port of the
reference's evaluation stack (behavior, not code):
 * tracklet labels   — kitti_sem_data_loader.py:60 load_tracklet +
   third_party/parseTrackletXML.py (tracklet_labels.xml of the raw drives)
 * detection labels  — kitti_detection_helper.py (KITTI object-detection txt)
 * OXTS -> T_w_imu   — pykitti-style Mercator pose chain
   (kitti_sem_data_loader.py:72 get_GroundTruth)
 * per-frame protocol — kitti_mapping_eval.py:84 evalaute(): GT kept when its
   projected 2D bbox overlaps a detection (iou_2d > threshold), nearest-center
   association, BEV IoU, PR counts at position {0.5, 1.0, 1.5} m (z ignored)
   x rotation {30, 45, inf} deg (yaw error mod 90 deg)
   (eval_precision_recall :270, cuboidIOU :165)
 * all-sequences aggregation — kitti_construct_pr_table_all_sequences.py
   (sum counts across drives, then precision = TP/pred, recall = TP/gt)

Everything is plain numpy (evaluation tooling, not a compute path).
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from .objects import POS_LEVELS, ROT_LEVELS, _clip_polygon, _poly_area

IOU_2D_THRESHOLD = 0.1  # utils.iou_2d_threshold
EARTH_RADIUS = 6378137.0


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

class Tracklet(NamedTuple):
    object_type: str
    h: float
    w: float
    l: float
    first_frame: int
    poses: np.ndarray  # (N, 6): tx ty tz rx ry rz (velodyne frame)


def parse_tracklet_xml(path: str) -> List[Tracklet]:
    """Parse a raw-drive ``tracklet_labels.xml`` (boost-serialization layout)."""
    root = ET.parse(path).getroot()
    tracklets = []
    for item in root.find("tracklets").findall("item"):
        poses = []
        for p in item.find("poses").findall("item"):
            poses.append([float(p.find(k).text)
                          for k in ("tx", "ty", "tz", "rx", "ry", "rz")])
        tracklets.append(Tracklet(
            object_type=item.find("objectType").text,
            h=float(item.find("h").text),
            w=float(item.find("w").text),
            l=float(item.find("l").text),
            first_frame=int(item.find("first_frame").text),
            poses=np.asarray(poses, float),
        ))
    return tracklets


class DetectionLabel(NamedTuple):
    cls_type: str
    truncation: float
    occlusion: float
    alpha: float
    box2d: np.ndarray  # (4,)
    h: float
    w: float
    l: float
    pos: np.ndarray  # (3,) camera frame (bottom center)
    ry: float
    score: float


def parse_detection_labels(path: str) -> List[DetectionLabel]:
    """KITTI object-detection label txt. Ref: kitti_detection_helper.py:23."""
    out = []
    with open(path) as f:
        for line in f:
            v = line.strip().split(" ")
            if len(v) < 15:
                continue
            out.append(DetectionLabel(
                cls_type=v[0], truncation=float(v[1]), occlusion=float(v[2]),
                alpha=float(v[3]),
                box2d=np.asarray([float(x) for x in v[4:8]]),
                h=float(v[8]), w=float(v[9]), l=float(v[10]),
                pos=np.asarray([float(x) for x in v[11:14]]),
                ry=float(v[14]),
                score=float(v[15]) if len(v) == 16 else -1.0,
            ))
    return out


def oxts_to_poses(lat_lon_alt: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """OXTS GPS/INS rows -> (N, 4, 4) T_w_imu, Mercator-projected at lat[0]."""
    lat, lon, alt = lat_lon_alt.T
    scale = math.cos(lat[0] * math.pi / 180.0)
    tx = scale * lon * math.pi / 180.0 * EARTH_RADIUS
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * math.pi / 360.0))
    t = np.stack([tx, ty, alt], axis=1)
    t = t - t[0]

    def rot(r, p, y):
        cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                                  np.cos(y), np.sin(y))
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        return Rz @ Ry @ Rx

    out = np.tile(np.eye(4), (len(lat), 1, 1))
    for i in range(len(lat)):
        out[i, :3, :3] = rot(*rpy[i])
        out[i, :3, 3] = t[i]
    return out


def _read_calib_file(path: str) -> Dict[str, np.ndarray]:
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                data[k.strip()] = np.asarray([float(x) for x in v.split()])
            except ValueError:
                pass
    return data


class RawCalib(NamedTuple):
    T_velo_imu: np.ndarray  # (4, 4)
    T_cam0_velo: np.ndarray  # (4, 4) rectified cam0 <- velo
    K: np.ndarray  # (3, 3) rectified cam0 intrinsics


def load_raw_calib(date_dir: str) -> RawCalib:
    """Parse calib_imu_to_velo / calib_velo_to_cam / calib_cam_to_cam of a
    raw-drive date directory into the transforms the evaluator needs."""
    def rt(d):
        T = np.eye(4)
        T[:3, :3] = d["R"].reshape(3, 3)
        T[:3, 3] = d["T"]
        return T

    T_velo_imu = rt(_read_calib_file(os.path.join(date_dir, "calib_imu_to_velo.txt")))
    T_cam_velo = rt(_read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt")))
    c2c = _read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    P = c2c["P_rect_00"].reshape(3, 4)
    return RawCalib(T_velo_imu=T_velo_imu, T_cam0_velo=R_rect @ T_cam_velo,
                    K=P[:, :3])


# ---------------------------------------------------------------------------
# per-frame GT cuboids (world frame)
# ---------------------------------------------------------------------------

class FrameCuboids(NamedTuple):
    corners: np.ndarray  # (M, 8, 3) world frame
    yaw: np.ndarray  # (M,)
    volume: np.ndarray  # (M,)


def _box_corners(h: float, w: float, l: float) -> np.ndarray:
    """(8, 3) canonical cuboid, z in [0, h]. Ref: generate_corners3d."""
    x = np.array([-l, -l, l, l, -l, -l, l, l]) / 2.0
    y = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    z = np.array([0, 0, 0, 0, h, h, h, h], float)
    return np.stack([x, y, z], axis=1)


def tracklet_frame_cuboids(tracklets: Sequence[Tracklet],
                           T_w_imu: np.ndarray, T_velo_imu: np.ndarray,
                           classes=("Car", "Van"),
                           ) -> Dict[int, FrameCuboids]:
    """Per-frame GT cuboids in the world frame.

    Tracklet poses live in the velodyne frame of their frame's scan; chain
    velo -> imu -> world with the per-frame OXTS pose.
    """
    T_imu_velo = np.linalg.inv(T_velo_imu)
    per_frame: Dict[int, list] = {}
    for tr in tracklets:
        if tr.object_type not in classes:
            continue
        box = _box_corners(tr.h, tr.w, tr.l)
        vol = tr.h * tr.w * tr.l
        for k, pose in enumerate(tr.poses):
            f = tr.first_frame + k
            if f >= len(T_w_imu):
                break
            tx, ty, tz, _, _, rz = pose
            c, s = math.cos(rz), math.sin(rz)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            corners_velo = box @ Rz.T + np.array([tx, ty, tz])
            T = T_w_imu[f] @ T_imu_velo
            corners_w = corners_velo @ T[:3, :3].T + T[:3, 3]
            R_w = T[:3, :3] @ Rz
            yaw_w = math.atan2(R_w[1, 0], R_w[0, 0])
            per_frame.setdefault(f, []).append((corners_w, yaw_w, vol))
    return {
        f: FrameCuboids(
            corners=np.stack([c for c, _, _ in rows]),
            yaw=np.asarray([y for _, y, _ in rows]),
            volume=np.asarray([v for _, _, v in rows]),
        )
        for f, rows in per_frame.items()
    }


def detection_frame_cuboids(labels: Sequence[DetectionLabel],
                            T_w_cam: np.ndarray, classes=("Car", "Van"),
                            ) -> FrameCuboids:
    """One frame's detection-label objects -> world cuboids.

    Detection positions are the bottom-center in the camera frame; ry is the
    rotation about the camera -y axis; the reference converts to a world-z
    yaw via yaw = -ry + pi/2 (kitti_detection_helper.py:77-84).
    """
    corners, yaws, vols = [], [], []
    for ob in labels:
        if ob.cls_type not in classes:
            continue
        yaw = -ob.ry + math.pi / 2
        box = _box_corners(ob.h, ob.w, ob.l)
        c, s = math.cos(yaw), math.sin(yaw)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        # world-frame box: rotate about world z at the object's world position
        # (cam -y up: bottom-center maps through the cam pose)
        pos_w = T_w_cam[:3, :3] @ ob.pos + T_w_cam[:3, 3]
        corners.append(box @ Rz.T + pos_w)
        yaws.append(yaw)
        vols.append(ob.h * ob.w * ob.l)
    if not corners:
        return FrameCuboids(np.zeros((0, 8, 3)), np.zeros(0), np.zeros(0))
    return FrameCuboids(np.stack(corners), np.asarray(yaws), np.asarray(vols))


# ---------------------------------------------------------------------------
# evaluation protocol
# ---------------------------------------------------------------------------

def bev_iou_corners(c1: np.ndarray, c2: np.ndarray) -> float:
    """BEV IoU of two cuboids given (8, 3) corners (z ignored — cuboidIOU:190)."""
    p1 = c1[:4, :2]
    p2 = c2[:4, :2]

    def ccw(p):
        ctr = p.mean(0)
        ang = np.arctan2(p[:, 1] - ctr[1], p[:, 0] - ctr[0])
        return p[np.argsort(ang)]

    p1, p2 = ccw(p1), ccw(p2)
    inter = _clip_polygon(p1, p2)
    ai = _poly_area(inter) if len(inter) >= 3 else 0.0
    a1, a2 = _poly_area(p1), _poly_area(p2)
    return float(ai / max(a1 + a2 - ai, 1e-9))


def project_cuboid_bbox(corners_w: np.ndarray, T_cam_w: np.ndarray,
                        K: np.ndarray) -> Optional[np.ndarray]:
    """Projected 2D bbox [xmin ymin xmax ymax] of a world cuboid, or None if
    behind the camera. Ref: project_gt_cuboid_to_image (kitti_mapping_eval.py:563)."""
    pc = corners_w @ T_cam_w[:3, :3].T + T_cam_w[:3, 3]
    if np.any(pc[:, 2] <= 0.1):
        return None
    uv = (pc @ K.T)
    uv = uv[:, :2] / uv[:, 2:3]
    return np.asarray([uv[:, 0].min(), uv[:, 1].min(),
                       uv[:, 0].max(), uv[:, 1].max()])


def iou_2d(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / max(ua, 1e-9))


class SequenceResult(NamedTuple):
    gt_num: float
    pred_num: float
    tpc: np.ndarray  # (3, 3) [rot_level][pos_level] TP counts
    ious: List[float]


class KittiObjectEvaluator:
    """Accumulates the reference's per-frame protocol over one sequence.

    Ref: kitti_mapping_eval.py ObjectEvaluator.evalaute (:84).
    """

    def __init__(self, gt_per_frame: Dict[int, FrameCuboids]):
        self.gt = gt_per_frame
        self.gt_num = 0.0
        self.pred_num = 0.0
        self.tpc = np.zeros((3, 3))
        self.ious: List[float] = []

    def add_frame(self, frame: int, pred_corners: np.ndarray,
                  pred_yaw: np.ndarray,
                  pred_bbox2d: Optional[np.ndarray] = None,
                  T_cam_w: Optional[np.ndarray] = None,
                  K: Optional[np.ndarray] = None):
        """Evaluate one frame's estimated objects against its GT.

        pred_corners (M, 8, 3) world; pred_yaw (M,). When pred_bbox2d +
        camera are given, GT is first gated by 2D-bbox overlap with the
        detections (the reference's keep_gt_idx); otherwise all GT count.
        """
        if frame not in self.gt or len(pred_corners) == 0:
            return
        gt = self.gt[frame]

        if pred_bbox2d is not None and T_cam_w is not None and K is not None:
            keep = []
            gt_boxes = [project_cuboid_bbox(c, T_cam_w, K) for c in gt.corners]
            for bbox in pred_bbox2d:
                best, best_g = 0.0, -1
                for g, gb in enumerate(gt_boxes):
                    if gb is None:
                        continue
                    i = iou_2d(gb, bbox)
                    if i > best:
                        best, best_g = i, g
                if best > IOU_2D_THRESHOLD:
                    keep.append(best_g)
            keep = list(dict.fromkeys(keep))  # dedup, order-preserving
            if not keep:
                return
            gt = FrameCuboids(gt.corners[keep], gt.yaw[keep], gt.volume[keep])

        # nearest-center association (z ignored), then BEV IoU + PR counts
        mean_gt = gt.corners.mean(axis=1).copy()
        mean_pr = pred_corners.mean(axis=1).copy()
        mean_gt[:, 2] = 0.0
        mean_pr[:, 2] = 0.0
        corr = np.argmin(
            ((mean_gt[:, None] - mean_pr[None]) ** 2).sum(-1), axis=1)

        self.gt_num += len(gt.corners)
        self.pred_num += len(pred_corners)
        for i in range(len(gt.corners)):
            j = int(corr[i])
            self.ious.append(bev_iou_corners(gt.corners[i], pred_corners[j]))
            pos_err = float(np.linalg.norm(mean_gt[i] - mean_pr[j]))
            rot_err = (abs(gt.yaw[i] - pred_yaw[j]) % (math.pi / 2)) * 180 / math.pi
            for ri, rl in enumerate(ROT_LEVELS):
                if ri == 2 or rot_err <= rl:  # last row ignores rotation
                    for pi_, pl in enumerate(POS_LEVELS):
                        if pos_err <= pl:
                            self.tpc[ri, pi_] += 1

    def result(self) -> SequenceResult:
        return SequenceResult(self.gt_num, self.pred_num, self.tpc.copy(),
                              list(self.ious))


def aggregate_pr(results: Sequence[SequenceResult]) -> dict:
    """Sum counts across sequences; emit precision/recall per cell.

    Ref: kitti_construct_pr_table_all_sequences.py (hand-summed counts)."""
    gt = sum(r.gt_num for r in results)
    pred = sum(r.pred_num for r in results)
    tpc = np.sum([r.tpc for r in results], axis=0)
    ious = [i for r in results for i in r.ious]
    return {
        "gt_num": gt, "pred_num": pred, "tpc": tpc,
        "recall": tpc / max(gt, 1.0),
        "precision": tpc / max(pred, 1.0),
        "mean_bev_iou": float(np.mean(ious)) if ious else 0.0,
    }


def pr_markdown(agg: dict) -> str:
    """Markdown PR table in the eval_results layout."""
    rows = ["| rot \\ pos | <= 0.5 m | <= 1.0 m | <= 1.5 m |",
            "|---|---|---|---|"]
    names = ["<= 30 deg", "<= 45 deg", "any rot"]
    for ri in range(3):
        cells = [f"{agg['recall'][ri, pi]:.3f} / {agg['precision'][ri, pi]:.3f}"
                 for pi in range(3)]
        rows.append(f"| {names[ri]} | " + " | ".join(cells) + " |")
    rows.append(f"\nGT objects: {agg['gt_num']:.0f}, predictions: "
                f"{agg['pred_num']:.0f}, mean BEV IoU {agg['mean_bev_iou']:.3f} "
                f"(cells: recall / precision)")
    return "\n".join(rows)
