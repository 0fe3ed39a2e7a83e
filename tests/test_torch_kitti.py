"""KITTI's readers and object evaluator: the port (orcvio_tpu_torch/dataio/
kitti.py, eval/kitti_objects.py) against the JAX package's modules on the
same fixtures, written in tmp_path as tests/test_kitti.py and
tests/test_kitti_objects.py write them (no KITTI data is needed). Every
output is identical: arrays bit for bit, strings and counts equal.
"""
import math

import numpy as np
import pytest

from orcvio_tpu.dataio import kitti as jk
from orcvio_tpu.eval import kitti_objects as jko
from orcvio_tpu_torch.dataio import kitti as pk
from orcvio_tpu_torch.eval import kitti_objects as pko
from test_kitti import make_fake_kitti_odom, make_fake_kitti_raw
from test_kitti_objects import DET_LABEL, TRACKLET_XML


def _same(a, b):
    """Equal leaves of two (nested) results: tuples, lists, dicts,
    arrays, numbers and strings."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) or (hasattr(a, "_fields")
                                      and a._fields == b._fields)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b or (a != a and b != b), (a, b)


def test_odometry_sequence(tmp_path):
    seq, poses = make_fake_kitti_odom(tmp_path)
    a, b = jk.load_kitti_odometry(seq, poses), pk.load_kitti_odometry(seq,
                                                                      poses)
    _same(tuple(a), tuple(b))
    assert b._fields == a._fields and b.gt_T.shape == (6, 4, 4)
    _same(tuple(jk.load_kitti_odometry(seq)), tuple(pk.load_kitti_odometry(
        seq)))


def test_oxts_and_frame_binning(tmp_path):
    drive = make_fake_kitti_raw(tmp_path, N=40)
    a, b = jk.load_kitti_oxts(drive), pk.load_kitti_oxts(drive)
    _same(tuple(a), tuple(b))
    for times, slab in ((np.asarray([0.03, 0.06, 0.09]), 8),
                        (np.arange(0.0, 0.4, 0.05), 3)):
        _same(jk.kitti_times_to_frame_stream(times, a.t, a.gyro, a.acc, slab),
              pk.kitti_times_to_frame_stream(times, b.t, b.gyro, b.acc, slab))


def test_labels_calib_and_cuboids(tmp_path):
    (tmp_path / "tracklet_labels.xml").write_text(TRACKLET_XML)
    (tmp_path / "000000.txt").write_text(DET_LABEL)
    (tmp_path / "calib_imu_to_velo.txt").write_text(
        "calib_time: x\nR: 1 0 0 0 1 0 0 0 1\nT: 0.1 0.2 0.3\n")
    (tmp_path / "calib_velo_to_cam.txt").write_text(
        "calib_time: x\nR: 0 -1 0 0 0 -1 1 0 0\nT: 0.5 0 -0.2\n")
    (tmp_path / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
        "P_rect_00: 700 0 600 0 0 700 180 0 0 0 1 0\n")
    xml = str(tmp_path / "tracklet_labels.xml")
    jt, pt = jko.parse_tracklet_xml(xml), pko.parse_tracklet_xml(xml)
    _same([tuple(t) for t in jt], [tuple(t) for t in pt])
    lab = str(tmp_path / "000000.txt")
    jl, pl = jko.parse_detection_labels(lab), pko.parse_detection_labels(lab)
    _same([tuple(x) for x in jl], [tuple(x) for x in pl])
    _same(tuple(jko.load_raw_calib(str(tmp_path))),
          tuple(pko.load_raw_calib(str(tmp_path))))
    rng = np.random.default_rng(0)
    lla = np.array([49.0, 8.43, 110.0]) + np.cumsum(
        rng.normal(0, 1e-5, (5, 3)), axis=0)
    rpy = rng.normal(0, 0.2, (5, 3))
    T_w_imu = jko.oxts_to_poses(lla, rpy)
    _same(T_w_imu, pko.oxts_to_poses(lla, rpy))
    T_velo_imu = jko.load_raw_calib(str(tmp_path)).T_velo_imu
    for classes in (("Car", "Van"), ("Car", "Pedestrian")):
        ja = jko.tracklet_frame_cuboids(jt, T_w_imu, T_velo_imu, classes)
        pa = pko.tracklet_frame_cuboids(pt, T_w_imu, T_velo_imu, classes)
        _same({k: tuple(v) for k, v in ja.items()},
              {k: tuple(v) for k, v in pa.items()})
        _same(tuple(jko.detection_frame_cuboids(jl, T_w_imu[2], classes)),
              tuple(pko.detection_frame_cuboids(pl, T_w_imu[2], classes)))
    _same(tuple(jko.detection_frame_cuboids(jl, np.eye(4), ("Tram",))),
          tuple(pko.detection_frame_cuboids(pl, np.eye(4), ("Tram",))))


def _random_cuboids(rng, n):
    out = []
    for _ in range(n):
        yaw = rng.uniform(-math.pi, math.pi)
        R = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                      [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
        box = jko._box_corners(*rng.uniform([1.2, 1.4, 3.0], [1.8, 1.9, 4.8]))
        out.append((box @ R.T + np.append(rng.uniform(-3, 25, 2), 0), yaw))
    return np.stack([c for c, _ in out]), np.asarray([y for _, y in out])


@pytest.mark.parametrize("gated", [False, True], ids=["all_gt", "2d_gate"])
def test_evaluator_and_pr_table(gated):
    rng = np.random.default_rng(1 + gated)
    gt = {}
    for f in range(6):
        c, y = _random_cuboids(rng, 4)
        gt[f] = jko.FrameCuboids(c, y, np.full(4, 10.0))
    T_cam_w = np.eye(4)
    T_cam_w[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    results = []
    for mod in (jko, pko):
        seqs = []
        for s in range(2):
            ev = mod.KittiObjectEvaluator(gt)
            r = np.random.default_rng(10 + s)
            for f in range(7):  # frame 6 has no ground truth
                src = gt.get(f, gt[0])
                n = int(r.integers(0, 5))
                idx = r.integers(0, 4, n)
                pc = src.corners[idx] + np.append(r.normal(0, 0.6, 2), 0)
                py = src.yaw[idx] + r.normal(0, 0.4, n)
                kw = {}
                if gated and n:
                    boxes = [mod.project_cuboid_bbox(c, T_cam_w, K)
                             for c in pc]
                    boxes = [b if b is not None else np.array(
                        [0.0, 0.0, 1.0, 1.0]) for b in boxes]
                    kw = dict(pred_bbox2d=np.stack(boxes), T_cam_w=T_cam_w,
                              K=K)
                ev.add_frame(f, pc, py, **kw)
            seqs.append(ev.result())
        agg = mod.aggregate_pr(seqs)
        results.append(([tuple(x) for x in seqs], agg, mod.pr_markdown(agg)))
    _same(results[0], results[1])
    assert results[1][1]["gt_num"] > 0
    a, b = _random_cuboids(rng, 2)[0]
    assert jko.bev_iou_corners(a, b) == pko.bev_iou_corners(a, b)
    assert jko.iou_2d(np.array([0, 0, 2, 2.0]), np.array([1, 1, 3, 3.0])) \
        == pko.iou_2d(np.array([0, 0, 2, 2.0]), np.array([1, 1, 3, 3.0]))
