"""Object-map evaluation: 3D IoU and precision/recall tables.

The port's copy of ``orcvio_tpu/eval/objects.py`` (numpy only), the
equivalent of the reference's Python evaluation stack
(``python_scripts/object_map_eval/utils.py``: iou_3d :62 — bird-eye-view
rotated-rect intersection x min-height, evaluate_precision_recall :330 —
position/rotation threshold grid from the VIS paper) and the matching logic
of ``unity_object_iou_eval.py`` (nearest-GT association, mean IoU over
matches with IoU > 0.2). Pure numpy host-side; the rotated-rect intersection
is a Sutherland-Hodgman convex clip (the reference uses shapely).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np


def _rect_corners(cx, cy, l, w, yaw):
    """BEV rectangle corners (4, 2): length along local x, width along y."""
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    half = np.array([[l / 2, w / 2], [-l / 2, w / 2], [-l / 2, -w / 2], [l / 2, -w / 2]])
    return half @ R.T + np.array([cx, cy])


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip convex `subject` by convex `clip` (CCW)."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a = clip[i]
        b = clip[(i + 1) % n]
        edge = b - a
        input_list = output
        output = []
        if not input_list:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= -1e-12

        def intersect(p, q):
            d1 = q - p
            denom = edge[0] * d1[1] - edge[1] * d1[0]
            if abs(denom) < 1e-15:
                return q
            t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
            return p + t * d1

        for j, cur in enumerate(input_list):
            prev = input_list[j - 1]
            if inside(cur):
                if not inside(prev):
                    output.append(intersect(prev, cur))
                output.append(cur)
            elif inside(prev):
                output.append(intersect(prev, cur))
    return np.asarray(output) if output else np.zeros((0, 2))


def _poly_area(pts: np.ndarray) -> float:
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _ccw(pts: np.ndarray) -> np.ndarray:
    x, y = pts[:, 0], pts[:, 1]
    if 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) < 0:
        return pts[::-1]
    return pts


def iou_3d(shape0, t0, yaw0, shape1, t1, yaw1) -> float:
    """3D IoU with BEV rotated rectangles x min height. Ref: utils.py:62-122.

    shape = (h, w, l); z ignored (boxes assumed ground-planted).
    """
    h0, w0, l0 = shape0
    h1, w1, l1 = shape1
    r0 = _ccw(_rect_corners(t0[0], t0[1], l0, w0, yaw0))
    r1 = _ccw(_rect_corners(t1[0], t1[1], l1, w1, yaw1))
    inter_area = _poly_area(_clip_polygon(r0, r1))
    if inter_area == 0:
        return 0.0
    inter_vol = inter_area * min(h0, h1)
    vol0 = h0 * w0 * l0
    vol1 = h1 * w1 * l1
    return float(inter_vol / (vol0 + vol1 - inter_vol))


def yaw_of_pose(T: np.ndarray) -> float:
    return float(math.atan2(T[1, 0], T[0, 0]))


def match_and_mean_iou(est_objects: List[dict], gt_objects: List[dict], iou_floor=0.2):
    """Unity-style evaluation. Ref: unity_object_iou_eval.py:41-74.

    Objects are dicts with keys: t (3,), yaw, shape (h, w, l). Each estimate
    matches its nearest GT by center distance; mean IoU is over matches whose
    IoU exceeds iou_floor. Returns (mean_iou, n_matched, per_pair list).
    """
    pairs = []
    for est in est_objects:
        if not gt_objects:
            break
        d = [np.linalg.norm(np.asarray(est["t"][:2]) - np.asarray(g["t"][:2])) for g in gt_objects]
        g = gt_objects[int(np.argmin(d))]
        iou = iou_3d(g["shape"], g["t"], g["yaw"], est["shape"], est["t"], est["yaw"])
        pairs.append((iou, est, g))
    good = [p[0] for p in pairs if p[0] > iou_floor]
    mean_iou = float(np.mean(good)) if good else 0.0
    return mean_iou, len(good), pairs


POS_LEVELS = (0.5, 1.0, 1.5)
ROT_LEVELS = (30.0, 45.0, math.inf)


def precision_recall_table(gt_t, gt_yaw, pred_t, pred_yaw):
    """3x3 PR counts at position/rotation thresholds. Ref: utils.py:330-416.

    Inputs are associated lists (same length). Rotation error ignores
    front/back ambiguity (mod pi/2, as the reference). Returns dict
    {(pos_level, rot_level): fraction}.
    """
    n = len(pred_yaw)
    tpc = np.zeros((3, 3))
    for i in range(n):
        t0 = np.asarray(gt_t[i], dtype=float).copy()
        t1 = np.asarray(pred_t[i], dtype=float).copy()
        t0[2] = 0.0
        t1[2] = 0.0
        pos_error = np.linalg.norm(t0 - t1)
        rot_error = (abs(abs(gt_yaw[i]) - abs(pred_yaw[i])) % (math.pi / 2)) * 180 / math.pi
        for pi_, pl in enumerate(POS_LEVELS):
            for ri, rl in enumerate(ROT_LEVELS):
                if pos_error <= pl and rot_error <= rl:
                    tpc[pi_, ri] += 1
    table = {}
    for pi_, pl in enumerate(POS_LEVELS):
        for ri, rl in enumerate(ROT_LEVELS):
            table[(pl, rl)] = float(tpc[pi_, ri] / max(n, 1))
    return table
