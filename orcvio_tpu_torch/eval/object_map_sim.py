"""Multi-object mapping on a synthetic world: config A of OBJECTS.md.

Counterpart of ``orcvio_tpu/eval/object_map_sim.py``: the full ObjectVio
pipeline (VIO, SORT, keypoint ingestion, triangulation and Kabsch, the
object LM, the object-residual EKF update) over a trajectory that circles
N ground-truth cars, the map scored with the reference's Unity protocol
(nearest-GT association, mean 3D IoU over matches with IoU > 0.2,
python_scripts/object_map_eval/unity_object_iou_eval.py:41-74) and the
position/rotation precision table (utils.py:330-416). The detections are
the ground-truth objects' analytic projections (the Unity pipeline's
role: the detector is an input of the mapper, not what is evaluated).
The world and the detections are numpy float64 on the host; the pipeline
runs on `device` (the card unless given).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig
from ..dataio.render_object import CAR_KEYPOINTS
from ..dataio.synthetic import SimConfig, generate, initial_state_np
from ..filter.pipeline import FrameInput
from ..filter.state import FilterState
from ..objects.lm import ObjectLMConfig
from ..objects.manager import ManagerConfig
from ..objects.sort import SortConfig
from ..objects.vio_objects import ObjectVio, ObjectVioConfig
from .objects import match_and_mean_iou, precision_recall_table, yaw_of_pose

R_B2C = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_C_B = np.array([0.05, 0.02, 0.0])
SHAPE_MEAN = (0.80, 2.00, 0.70)


@dataclass
class WorldConfig:
    n_objects: int = 12
    n_frames: int = 300          # some 15 s at 20 Hz: a bit over one orbit
    ring_radius: float = 7.0     # the objects' ring around the path's centre
    seed: int = 7
    kp_noise: float = 1.5e-3     # keypoint noise, normalized coordinates
    uv_noise: float = 0.002      # VIO feature noise
    max_det: int = 8             # detection slots a frame
    fov: float = 0.9
    min_depth: float = 2.0
    max_depth: float = 14.0


def _rot_z(yaw):
    """so3.exp([0, 0, yaw]) in float64, Rodrigues' form."""
    W = np.array([[0.0, -yaw, 0.0], [yaw, 0.0, 0.0], [0.0, 0.0, 0.0]])
    t2 = yaw * yaw
    if t2 < 1e-10:
        a, b = 1.0 - t2 / 6.0 + t2 * t2 / 120.0, 0.5 - t2 / 24.0 + \
            t2 * t2 / 720.0
    else:
        th = np.sqrt(t2)
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / (th * th)
    return np.eye(3) + a * W + b * (W @ W)


def make_world(wc: WorldConfig):
    """The ground-truth objects, on a ring around the trajectory's centre."""
    rng = np.random.default_rng(wc.seed)
    n = wc.n_objects
    az = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(-0.1, 0.1,
                                                                    n)
    center = np.array([0.0, 3.0, 0.0])
    objs = []
    for i in range(n):
        scale = rng.uniform(0.9, 1.1)
        kps_gt = CAR_KEYPOINTS * scale + rng.normal(size=(12, 3)) * 0.02
        shape_gt = np.array([0.80, 2.00, 0.70]) * scale  # semi-axes
        yaw = rng.uniform(-np.pi, np.pi)
        t = center + np.array([wc.ring_radius * np.cos(az[i]),
                               wc.ring_radius * np.sin(az[i]), 0.0])
        wTo = np.eye(4)
        wTo[:3, :3] = _rot_z(yaw)
        wTo[:3, 3] = t
        objs.append(dict(kps=kps_gt, shape=shape_gt, wTo=wTo, yaw=yaw, t=t,
                         scale=scale))
    return objs


def _inverse_pose(T):
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def ellipsoid_bbox(cTw, wTo, shape):
    """The projected bbox of the ellipsoid (the reference's quadric
    projection), or None where the conic degenerates."""
    Qi = np.diag(np.concatenate([np.asarray(shape) ** 2, [-1.0]]))
    P_o = np.asarray(cTw)[:3, :] @ np.asarray(wTo)
    C = P_o @ Qi @ P_o.T
    if not abs(C[2, 2]) > 1e-9:
        return None
    sx = np.sqrt(max(C[0, 2] ** 2 - C[2, 2] * C[0, 0], 1e-12)) / abs(C[2, 2])
    sy = np.sqrt(max(C[1, 2] ** 2 - C[2, 2] * C[1, 1], 1e-12)) / abs(C[2, 2])
    cx = C[0, 2] / C[2, 2]
    cy = C[1, 2] / C[2, 2]
    return np.array([cx - sx, cy - sy, cx + sx, cy + sy])


def analytic_detections(wc: WorldConfig, objs, wTc, rng):
    """One frame's detections: the visible objects' keypoints and bboxes.
    Returns (boxes, classes, kps, kps_mask, valid, truth) as numpy."""
    cTw = _inverse_pose(np.asarray(wTc))
    M = wc.max_det
    boxes = np.zeros((M, 4))
    classes = np.zeros(M, np.int32)
    kps = np.zeros((M, 12, 2))
    kmask = np.zeros((M, 12), bool)
    valid = np.zeros(M, bool)
    truth = -np.ones(M, np.int32)
    m = 0
    for i, ob in enumerate(objs):
        if m >= M:
            break
        pc = cTw[:3, :3] @ ob["t"] + cTw[:3, 3]
        if not (wc.min_depth < pc[2] < wc.max_depth):
            continue
        if abs(pc[0] / pc[2]) > wc.fov or abs(pc[1] / pc[2]) > wc.fov:
            continue
        bb = ellipsoid_bbox(cTw, ob["wTo"], ob["shape"])
        if bb is None:
            continue
        kw = (ob["wTo"][:3, :3] @ ob["kps"].T).T + ob["wTo"][:3, 3]
        kc = (cTw[:3, :3] @ kw.T).T + cTw[:3, 3]
        z = kc[:, 2]
        uv = kc[:, :2] / z[:, None]
        boxes[m] = bb
        kps[m] = uv + rng.normal(size=uv.shape) * wc.kp_noise
        kmask[m] = z > wc.min_depth * 0.8
        valid[m] = True
        truth[m] = i
        m += 1
    return boxes, classes, kps, kmask, valid, truth


def world_sim(wc: WorldConfig) -> SimConfig:
    """The VIO stream of the world's trajectory."""
    return SimConfig(n_frames=wc.n_frames, n_landmarks=400, max_obs=50,
                     uv_noise=wc.uv_noise, seed=wc.seed, radius=3.0,
                     omega=0.5)


def object_vio_config(wc: WorldConfig,
                      use_object_update: bool = True) -> ObjectVioConfig:
    """The pipeline's configuration on the world (config A)."""
    sim = world_sim(wc)
    return ObjectVioConfig(
        filter=FilterConfig(sw_size=10, max_features=80, max_track_len=6,
                            imu_slab=sim.imu_slab, observation_noise=0.004,
                            tri_translation_threshold=-1.0,
                            object_residual_transport=True),
        lm=ObjectLMConfig(iters=25),
        manager=ManagerConfig(capacity=wc.max_det + 4, window=45, n_kps=12,
                              pose_history=256, min_frames=12,
                              smooth_keypoints=True),
        sort=SortConfig(capacity=wc.max_det + 4, max_age=3, min_hits=2,
                        iou_threshold=0.1),
        kps_mean=tuple(map(tuple, CAR_KEYPOINTS)), shape_mean=SHAPE_MEAN,
        use_object_residual_update=use_object_update, merge_duplicates=True,
        finalize_budget=1)


def initial_filter_state(fcfg: FilterConfig, sim: SimConfig, dtype, device):
    """The filter started at the ground truth (initial_use_gt mode,
    orcvio.cpp:123-146), its IMU block's variances 1e-6."""
    st = FilterState.create(fcfg, dtype, device)
    R0, p0, v0 = initial_state_np(sim)

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    imu = st.imu.replace(R=put(R0), p=put(p0), v=put(v0))
    d = np.asarray(fcfg.initial_cov_diag())
    d[:15] = 1e-6
    return st.replace(imu=imu, imu_fej_now=imu, imu_old=imu, R_b2c=put(R_B2C),
                      t_c_b=put(T_C_B), P=put(np.diag(d)),
                      initialized=torch.ones((), dtype=torch.bool,
                                             device=device))


def camera_pose(gt_R, gt_p):
    """wTc (4, 4) of the camera on a body pose."""
    wTc = np.eye(4)
    wTc[:3, :3] = gt_R @ R_B2C.T
    wTc[:3, 3] = gt_p + gt_R @ T_C_B
    return wTc


def detection_stream(wc: WorldConfig, objs, gt_R, gt_p, rng):
    """Every frame's detections from the ground-truth camera poses, as
    stacked numpy arrays (boxes, classes, kps, kps_mask, valid)."""
    dets = [analytic_detections(wc, objs, camera_pose(gt_R[k], gt_p[k]),
                                rng)[:5] for k in range(wc.n_frames)]
    return tuple(np.stack(x) for x in zip(*dets))


def score_map(object_map, objs):
    """(mean IoU, matched, pairs, PR table) of a map against the world."""
    est = [dict(t=np.asarray(o["wTo"])[:3, 3], yaw=yaw_of_pose(
        np.asarray(o["wTo"])), shape=(2 * o["shape"][2], 2 * o["shape"][1],
                                      2 * o["shape"][0]))
           for o in object_map.values()]
    gt = [dict(t=o["t"], yaw=yaw_of_pose(o["wTo"]),
               shape=(2 * o["shape"][2], 2 * o["shape"][1],
                      2 * o["shape"][0])) for o in objs]
    mean_iou, n_matched, pairs = match_and_mean_iou(est, gt)
    pr = precision_recall_table(
        [p[2]["t"] for p in pairs], [p[2]["yaw"] for p in pairs],
        [p[1]["t"] for p in pairs], [p[1]["yaw"] for p in pairs],
    ) if pairs else {}
    return mean_iou, n_matched, pairs, pr, len(est), len(gt)


def run_object_mapping(wc: WorldConfig, use_object_update: bool = True,
                       dtype=torch.float64, collect_diag: bool = False,
                       device=None):
    """The whole pipeline over the world; returns a dict of the IoU
    figures, the ATE, the map and (collect_diag) each update's
    diagnostics."""
    device = resolve_device(device)
    no_tf32()
    rng = np.random.default_rng(wc.seed + 1)
    objs = make_world(wc)
    sim = world_sim(wc)
    data = generate(sim, R_b2c=R_B2C, t_c_b=T_C_B, dtype=dtype, device=device)
    gt_R = data.gt_R.cpu().numpy()
    gt_p = data.gt_p.cpu().numpy()
    ocfg = object_vio_config(wc, use_object_update)
    ov = ObjectVio(ocfg, max_obs=sim.max_obs, dtype=dtype, device=device)

    diag_log: List[dict] = []
    if collect_diag:
        def _hook(oid, fs_before, fs_after, used, diag, entry):
            # the clones' position error against the ground truth, before
            # and after this update
            tb = fs_before.clones.t.cpu().numpy()
            val = fs_before.clones.valid.cpu().numpy()
            idx = np.clip(np.rint(tb * sim.frame_hz).astype(int) - 1, 0,
                          wc.n_frames - 1)
            eb = np.linalg.norm(fs_before.clones.p.cpu().numpy() - gt_p[idx],
                                axis=1)
            ea = np.linalg.norm(fs_after.clones.p.cpu().numpy() - gt_p[idx],
                                axis=1)
            diag_log.append(dict(
                oid=int(oid), used=bool(used), gamma=float(diag.gamma),
                dof=int(diag.dof), threshold=float(diag.threshold),
                n_rows=int(diag.n_rows), n_frames=int(diag.n_frames),
                dx_clone_p=float(diag.dx_clone_p),
                err_before=float(np.mean(eb[val])),
                err_after=float(np.mean(ea[val])),
                r_rms=float(diag.r_rms), rp_rms=float(diag.rp_rms),
                h_max=float(diag.h_max), lm_cost=entry["lm_cost"],
                n_obs_frames=len(entry["timestamps"])))
        ov.update_hook = _hook

    ov.set_filter_state(initial_filter_state(ocfg.filter, sim, dtype, device))
    dets = detection_stream(wc, objs, gt_R, gt_p, rng)
    frames = data.frames
    est_p = np.zeros((wc.n_frames, 3))
    for k in range(wc.n_frames):
        out = ov.step(FrameInput(*(x[k] for x in frames)),
                      *(x[k] for x in dets))
        est_p[k] = out.p.cpu().numpy()
    # flush: empty frames until SORT has aged out every live track
    last = FrameInput(*(x[wc.n_frames - 1] for x in frames))
    M = wc.max_det
    for _ in range(ocfg.sort.max_age + 2):
        ov.step(last, np.zeros((M, 4)), np.zeros(M, np.int32),
                np.zeros((M, 12, 2)), np.zeros((M, 12), bool),
                np.zeros(M, bool))

    mean_iou, n_matched, pairs, pr, n_est, n_gt = score_map(ov.object_map,
                                                            objs)
    ate = float(np.sqrt(np.mean(np.sum((est_p - gt_p) ** 2, axis=1))))
    return dict(mean_iou=mean_iou, n_matched=n_matched, n_est=n_est,
                n_gt=n_gt, pairs=pairs, pr=pr, ate_m=ate,
                object_map=ov.object_map, est_p=est_p, gt_p=gt_p,
                diag=diag_log)
