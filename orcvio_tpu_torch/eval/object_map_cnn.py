"""Object mapping with the keypoint network in the loop: config B of
OBJECTS.md.

Counterpart of ``orcvio_tpu/eval/object_map_cnn.py``: composite renders of
several cars, their pixel bboxes, the StarMap keypoint network, SORT,
keypoint ingest, init and LM, the object-residual EKF update and the map,
the reference's darknet -> StarMap -> ObjectInitNode chain
(``ros_wrapper/src/StarMap/src/starmap.cpp:606-696``,
``ObjectInitNode.cpp:408-740``) with the detector itself under test. The
world, the renders and the scoring are numpy on the host; the filter, the
object layer and the network run on `device` (the card unless given).

``debug=True`` records each frame's stage counts (boxes rendered,
keypoints found, live SORT tracks, the table's objects and their frames)
and each finalization's inputs, so a map without objects points to the
stage that dropped them. It only observes: the frames run through
``ObjectVio.step_image`` as without it (the JAX package's debug mode
calls the detector and ``step`` itself, so it keeps the boxes that
``step_image`` drops as too small).
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig
from ..dataio.render_object import CAR_KEYPOINTS, render_car
from ..dataio.synthetic import generate
from ..filter.pipeline import FrameInput
from ..objects.detector import StarMapKeypointDetector
from ..objects.lm import ObjectLMConfig
from ..objects.manager import ManagerConfig
from ..objects.sort import SortConfig
from ..objects.vio_objects import ObjectVio, ObjectVioConfig
from .object_map_sim import (R_B2C, T_C_B, WorldConfig, _inverse_pose,
                             camera_pose, initial_filter_state, make_world,
                             world_sim)
from .objects import match_and_mean_iou, yaw_of_pose

SIZE = 240  # the square canvas, and the image's height and width
FOCAL = 220.0
MAX_BOXES = 4  # detection slots a frame


def world_config(quick: bool = False) -> WorldConfig:
    """Config B's world: 3 cars on a 6.5 m ring; the full run covers one
    orbit (2 pi / (omega dt), some 252 frames) so that every car enters
    the view, quick some third of it (one car)."""
    n = 80 if quick else 260
    return WorldConfig(n_objects=3, n_frames=n, ring_radius=6.5,
                       max_det=MAX_BOXES, seed=11)


def camera_K():
    return (FOCAL, FOCAL, SIZE / 2, SIZE / 2)


def object_vio_config(wc: WorldConfig, use_object_update: bool = True,
                      sigma_obj: float = 0.05, min_frames: int = 10,
                      smooth_keypoints: bool = False) -> ObjectVioConfig:
    """The pipeline's configuration in config B. Keypoint smoothing is
    off by default: the detector localizes at 3-5 px, where the
    constant-velocity KF's lag under orbital motion costs more than the
    noise it removes."""
    sim = world_sim(wc)
    fcfg = FilterConfig(sw_size=10, max_features=80, max_track_len=6,
                        imu_slab=sim.imu_slab, observation_noise=0.004,
                        object_observation_noise=sigma_obj,
                        tri_translation_threshold=-1.0)
    return ObjectVioConfig(
        filter=fcfg, lm=ObjectLMConfig(iters=25),
        manager=ManagerConfig(capacity=8, window=45, n_kps=12,
                              pose_history=256, min_frames=min_frames,
                              smooth_keypoints=smooth_keypoints),
        sort=SortConfig(capacity=8, max_age=3, min_hits=2, iou_threshold=0.1),
        kps_mean=tuple(map(tuple, CAR_KEYPOINTS)),
        shape_mean=(0.80, 2.00, 0.70),
        use_object_residual_update=use_object_update,
        merge_duplicates=True)


def render_frame(wc: WorldConfig, objs, wTc, rng):
    """Every visible car composited into one image, far to near (the
    painter's order): (img (H, W) float32 in [0, 1], pixel bboxes (n, 4)
    of the cars with at least 4 visible keypoints)."""
    H = W = SIZE
    K = camera_K()
    cTw = _inverse_pose(np.asarray(wTc))
    img = np.full((H, W), 0.35, np.float32)
    boxes = []
    order = []
    for i, ob in enumerate(objs):
        pc = cTw[:3, :3] @ ob["t"] + cTw[:3, 3]
        if not (wc.min_depth < pc[2] < wc.max_depth):
            continue
        if abs(pc[0] / pc[2]) > 0.55 or abs(pc[1] / pc[2]) > 0.55:
            continue
        order.append((pc[2], i))
    for _, i in sorted(order, reverse=True):
        ob = objs[i]
        Ro, to = ob["wTo"][:3, :3], ob["wTo"][:3, 3]
        R_w2c_o = cTw[:3, :3] @ Ro
        cam_o = Ro.T @ (np.asarray(wTc)[:3, 3] - to)
        r = render_car(R_w2c_o, cam_o, K, SIZE, background=img, rng=rng)
        img = np.asarray(r.image)
        vis = r.kp_visible
        if vis.sum() >= 4:
            uv = r.kp_uv[vis]
            x0, y0 = uv[:, 0].min() - 3, uv[:, 1].min() - 3
            x1, y1 = uv[:, 0].max() + 3, uv[:, 1].max() + 3
            if x1 < W + 10 and y1 < H + 10:
                boxes.append([x0, y0, min(x1, W - 1), min(y1, H - 1)])
    return img, np.asarray(boxes, np.float64).reshape(-1, 4)


def frame_boxes(boxes):
    """The first MAX_BOXES boxes in fixed slots: (boxes (M, 4), valid)."""
    bx = np.zeros((MAX_BOXES, 4))
    valid = np.zeros(MAX_BOXES, bool)
    nb = min(len(boxes), MAX_BOXES)
    bx[:nb] = boxes[:nb]
    valid[:nb] = True
    return bx, valid


class _Timed:
    """The detector with the host seconds its calls took and its last
    output."""

    def __init__(self, detector):
        self.detector = detector
        self.K_cam = detector.K_cam
        self.seconds = 0.0
        self.last = None

    def __call__(self, *args):
        t0 = time.perf_counter()
        self.last = self.detector(*args)
        self.seconds += time.perf_counter() - t0
        return self.last


def run_cnn_object_mapping(quick: bool = False, debug: bool = False,
                           use_object_update: bool = True,
                           sigma_obj: float = 0.05, min_frames: int = 10,
                           smooth_keypoints: bool = False, device=None):
    """The whole chain over config B's world; returns a dict of the IoU
    figures, the map, the host seconds over the frames and the flush
    frames (n_steps; split into render, detector and the rest of the
    step), the finalizations and the updates tried and applied (and with
    `debug`, the per-frame stages and the finalizations' inputs)."""
    device = resolve_device(device)
    no_tf32()
    dtype = torch.float64
    wc = world_config(quick)
    n_frames = wc.n_frames
    objs = make_world(wc)
    rng = np.random.default_rng(5)
    sim = world_sim(wc)
    data = generate(sim, R_b2c=R_B2C, t_c_b=T_C_B, dtype=dtype, device=device)
    gt_R = data.gt_R.cpu().numpy()
    gt_p = data.gt_p.cpu().numpy()
    ocfg = object_vio_config(wc, use_object_update, sigma_obj, min_frames,
                             smooth_keypoints)
    ov = ObjectVio(ocfg, max_obs=sim.max_obs, dtype=dtype, device=device)
    detector = _Timed(StarMapKeypointDetector(CAR_KEYPOINTS, camera_K(),
                                              device=device))
    ov.set_filter_state(initial_filter_state(ocfg.filter, sim, dtype,
                                             device))

    updates: List[bool] = []
    ov.update_hook = lambda oid, fs0, fs1, used, diag, entry: \
        updates.append(bool(used))
    fin_log: List[dict] = []
    finalize = ov._finalize

    def logged_finalize(*a):
        fin, exp, wTc_obj, d_ = finalize(*a)
        entry = dict(ok=bool(fin.ok), lm_cost=float(fin.lm_cost),
                     wTo_t=fin.wTo[:3, 3].cpu().numpy().tolist())
        if debug:
            entry.update(inputs=[x.cpu().numpy() for x in a[:6]],
                         poses=a[6])
        fin_log.append(entry)
        return fin, exp, wTc_obj, d_
    ov._finalize = logged_finalize

    stages: List[dict] = []
    t_render = 0.0
    t0 = time.perf_counter()
    frames = data.frames
    zero_cls = np.zeros(MAX_BOXES, np.int32)
    for k in range(n_frames):
        t1 = time.perf_counter()
        img, boxes = render_frame(wc, objs, camera_pose(gt_R[k], gt_p[k]),
                                  rng)
        t_render += time.perf_counter() - t1
        bx, valid = frame_boxes(boxes)
        ov.step_image(FrameInput(*(x[k] for x in frames)), img * 255.0, bx,
                      zero_cls, valid, detector)
        if debug:
            live = ov.sort.track_id.cpu().numpy() >= 0
            oid = ov.table.oid.cpu().numpy()
            kps_mask = detector.last[1]
            stages.append(dict(
                frame=k, n_boxes=int(valid.sum()),
                kp_found=kps_mask.sum(axis=1)[valid].tolist(),
                sort_live=int(live.sum()),
                table_oids=oid[oid >= 0].tolist(),
                table_n=ov.table.n.cpu().numpy()[oid >= 0].tolist()))
    # flush: empty frames until SORT has aged out every live track
    last = FrameInput(*(x[n_frames - 1] for x in frames))
    for _ in range(ocfg.sort.max_age + 2):
        ov.step_image(last, np.full((SIZE, SIZE), 90.0),
                      np.zeros((MAX_BOXES, 4)), zero_cls,
                      np.zeros(MAX_BOXES, bool), detector)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    est_list = [
        dict(t=np.asarray(o["wTo"])[:3, 3],
             yaw=yaw_of_pose(np.asarray(o["wTo"])),
             shape=(2 * o["shape"][2], 2 * o["shape"][1], 2 * o["shape"][0]))
        for o in ov.object_map.values()
    ]
    gt_list = [
        dict(t=o["t"], yaw=yaw_of_pose(o["wTo"]),
             shape=(2 * o["shape"][2], 2 * o["shape"][1], 2 * o["shape"][0]))
        for o in objs
    ]
    mean_iou, n_matched, pairs = match_and_mean_iou(est_list, gt_list)
    n_steps = n_frames + ocfg.sort.max_age + 2
    return dict(mean_iou=mean_iou, n_matched=n_matched, n_est=len(est_list),
                n_gt=len(gt_list), seconds=dt,
                seconds_split=dict(render=t_render,
                                   detector=detector.seconds,
                                   step=dt - t_render - detector.seconds),
                n_steps=n_steps, ms_per_frame=1e3 * dt / n_steps,
                stages=stages,
                finalizations=fin_log, updates_tried=len(updates),
                updates_applied=sum(updates), object_map=ov.object_map,
                gt_list=gt_list)
