"""The object layer's host side: evaluation, persistence, the class
config and the synthetic world, the port against the JAX package.

3D IoU, the Unity matching and the precision table agree within 1e-12;
the persistence writer writes the same text as the JAX package's and
reads back what it wrote; the class config (object_feat_*.yaml in the
reference's layout, written to tmp_path since the reference is not in
the repo) loads the same, aliases included; the world, its ellipsoid
boxes and its detections agree within 1e-12.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from orcvio_tpu.config import objects_yaml as jyaml
from orcvio_tpu.eval import object_map_sim as jsim
from orcvio_tpu.eval import objects as jev
from orcvio_tpu.objects import persistence as jpers
from orcvio_tpu_torch.config import objects_yaml as pyaml
from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
from orcvio_tpu_torch.eval import object_map_sim as psim
from orcvio_tpu_torch.eval import objects as pev
from orcvio_tpu_torch.objects import persistence as ppers

TOL = 1e-12


def random_objects(n, seed):
    rng = np.random.default_rng(seed)
    return [dict(t=rng.normal(size=3) * 2, yaw=rng.uniform(-np.pi, np.pi),
                 shape=tuple(rng.uniform(0.5, 4.5, size=3))) for _ in range(n)]


def test_iou_3d():
    objs = random_objects(12, 1)
    for a in objs:
        for b in objs:
            args = (a["shape"], a["t"], a["yaw"], b["shape"], b["t"], b["yaw"])
            assert abs(pev.iou_3d(*args) - jev.iou_3d(*args)) <= TOL
    s = (1.5, 1.8, 4.5)
    assert pev.iou_3d(s, (0, 0, 0), 0.3, s, (0, 0, 0), 0.3) == \
        pytest.approx(1.0)


def test_matching_and_precision_table():
    est, gt = random_objects(9, 2), random_objects(7, 3)
    for e in est[:5]:  # some near their ground truth
        g = gt[int(np.argmin([np.linalg.norm(e["t"][:2] - g["t"][:2])
                              for g in gt]))]
        e.update(t=g["t"] + 0.1, yaw=g["yaw"] + 0.05, shape=g["shape"])
    pm, pn, pp = pev.match_and_mean_iou(est, gt)
    jm, jn, jp = jev.match_and_mean_iou(est, gt)
    assert pn == jn and pn >= 5 and abs(pm - jm) <= TOL
    assert [p[0] for p in pp] == pytest.approx([p[0] for p in jp], abs=TOL)
    args = ([p[2]["t"] for p in pp], [p[2]["yaw"] for p in pp],
            [p[1]["t"] for p in pp], [p[1]["yaw"] for p in pp])
    assert pev.precision_recall_table(*args) == \
        jev.precision_recall_table(*args)
    assert pev.yaw_of_pose(np.eye(4)) == jev.yaw_of_pose(np.eye(4)) == 0.0


def test_persistence_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    wTq = np.eye(4)
    wTq[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    wTq[:3, 3] = rng.normal(size=3)
    args = (7, "car", wTq, rng.normal(size=(12, 3)), rng.uniform(size=3),
            [0.05 * k for k in range(1, 9)])
    p = ppers.save_object_state(str(tmp_path / "port_%d.txt"), *args)
    j = jpers.save_object_state(str(tmp_path / "jax_%d.txt"), *args)
    assert p.endswith("port_7.txt")
    assert open(p).read() == open(j).read()
    back = ppers.load_object_state(p)
    ref = jpers.load_object_state(j)
    assert back["object_id"] == 7 and back["object_class"] == "car"
    for k in ("wTq", "kps_global", "ellipsoid_shape", "timestamps"):
        np.testing.assert_array_equal(back[k], ref[k])
    np.testing.assert_allclose(back["wTq"], wTq, atol=1e-8)


CONFIG = """object_classes:
  car:
    keypoints_num: 12
    object_keypoints_mean: [{xs},
                            {ys},
                            {zs}]
    object_mean_shape: [1.6, 3.9, 1]
    aliases: [truck, bus]
    marker_color: [0.0, 0.0, 1.0]
  door:
    keypoints_num: 4
    object_keypoints_mean: [-0.5, 0.5, 0.5, -0.5, 0, 0, 0, 0, 0, 0, 2, 2]
    object_mean_shape: [1.0, 0.1, 2.0]
    aliases:
      - gate
    marker_color: [1, 0, 0]
"""


def test_load_object_config(tmp_path):
    path = tmp_path / "object_feat_test.yaml"
    path.write_text(CONFIG.format(
        **{c: ", ".join(f"{v:g}" for v in CAR_KEYPOINTS[:, i])
           for i, c in enumerate(("xs", "ys", "zs"))}))
    pc, jc = pyaml.load_object_config(str(path)), \
        jyaml.load_object_config(str(path))
    assert sorted(pc) == sorted(jc) == ["bus", "car", "door", "gate", "truck"]
    for name in jc:
        assert dataclasses.asdict(pc[name]) == dataclasses.asdict(jc[name])
    assert pc["truck"] is pc["car"]
    np.testing.assert_array_equal(pc["car"].keypoints_mean_np, CAR_KEYPOINTS)
    for a, b in zip(pyaml.scale_mean_shape(CAR_KEYPOINTS, (4.5, 1.8, 1.5),
                                           (1, 0, 2)),
                    jyaml.scale_mean_shape(CAR_KEYPOINTS, (4.5, 1.8, 1.5),
                                           (1, 0, 2))):
        np.testing.assert_array_equal(a, b)


def test_world_and_detections():
    wc_p, wc_j = psim.WorldConfig(n_frames=20), jsim.WorldConfig(n_frames=20)
    po, jo = psim.make_world(wc_p), jsim.make_world(wc_j)
    for a, b in zip(po, jo):
        for k in ("kps", "shape", "wTo", "t"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
        assert a["yaw"] == b["yaw"] and a["scale"] == b["scale"]
    rng_p, rng_j = (np.random.default_rng(8) for _ in range(2))
    for k in range(0, 20, 3):
        ang = 0.3 * k
        wTc = np.eye(4)
        wTc[:3, :3] = np.array([[math.cos(ang), 0, math.sin(ang)],
                                [-math.sin(ang), 0, math.cos(ang)],
                                [0, -1, 0]])
        wTc[:3, 3] = [0.3 * k, 3.0, 0.2]
        dp = psim.analytic_detections(wc_p, po, wTc, rng_p)
        dj = jsim.analytic_detections(wc_j, jo, jnp.asarray(wTc), rng_j)
        for a, b in zip(dp, dj):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)
    assert dp[4].any()
