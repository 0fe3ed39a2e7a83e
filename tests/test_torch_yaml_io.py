"""The port's config reader and writer against the JAX package's.

* write_reference_config writes the JAX package's text byte for byte,
  with and without overrides.
* load_reference_yaml (the port's own FileStorage reader) gives every
  field of FilterConfig, CameraConfig and FrontendConfig equal to the JAX
  package's cv2.FileStorage reader: on the writer's config, on a config
  with comments, quoted strings, a float32 !!opencv-matrix whose data
  spans lines and the GT initial state (initial_use_gt: 1), and on a
  config whose keys are missing (the defaults).
* load_initial_state gives the same arrays, or None where the file does
  not set initial_use_gt.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("cv2")

from orcvio_tpu.config import yaml_io as jyaml  # noqa: E402
from orcvio_tpu.dataio import euroc_writer as jwriter  # noqa: E402
from orcvio_tpu.dataio.synthetic import SimConfig as JaxSim  # noqa: E402
from orcvio_tpu_torch.config import yaml_io as pyaml  # noqa: E402
from orcvio_tpu_torch.dataio import euroc_writer as pwriter  # noqa: E402
from orcvio_tpu_torch.dataio.synthetic import SimConfig  # noqa: E402

SIM = dict(n_frames=10, frame_hz=20.0)
CAM = dict(width=160, height=120, fx=98.5, fy=97.25, cx=80.0, cy=60.0)

GT_CONFIG = """%YAML:1.0
---
# a hand-written config: comments, quotes, a float32 matrix over lines
output_dir: "/x/y#not-a-comment/"   # trailing comment
camera_model: pinhole
distortion_model: 'equidistant'
resolution_width: 640
resolution_height: 400
intrinsics:
   fx: 400
   fy: 401.5
   cx: 3.2e2
   cy: 199.75
distortion_coeffs:
   k1: -0.28
   k2: 0.07
   p1: 1e-4
   p2: -2.5e-05
T_cam_imu: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [ 0.0148655429818, -0.999880929698, 0.00414029679422,
       -0.0216401454975, 0.999557249008, 0.0149672133247, 0.025715529948,
       -0.064676986768, -0.0257744366974, 0.00375618835797, 0.999660727178,
       0.00981073058949, 0., 0., 0., 1. ]
sw_size: 12
max_features_num: 150
use_larvio_flag: 1
use_left_perturbation_flag: 0
if_ZUPT_valid: 2
noise_gyro: 1.6968e-04
noise_feature: 0.01
feature_idp_dim: 1
max_features_in_one_grid: 2
aug_grid_rows: 4
aug_grid_cols: 4
static_image_num: 12.9
flag_equalize: 0
pub_frequency: 20
td: -0.0025
initial_use_gt: 1
initial_state_time: 1403636579.763555527
initial_quat: !!opencv-matrix
   rows: 4
   cols: 1
   dt: d
   data: [ 0.153, -0.8273, -0.08215, 0.5341 ]
initial_vel: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [ 0.005, -0.017, 0.011 ]
initial_pos: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data:
      [ 4.688, -1.786, 0.783 ]
initial_bg: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [ -0.002, 0.0208, 0.0766 ]
initial_ba: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [ -0.0126, 0.0874, 0.0749 ]
"""


def _writer_config(tmp_path, package, **overrides):
    if package == "jax":
        wc = jwriter.WriterConfig(cam=jwriter.CameraModel(**CAM))
        write, sim = jwriter.write_reference_config, JaxSim(**SIM)
    else:
        wc = pwriter.WriterConfig(cam=pwriter.CameraModel(**CAM))
        write, sim = pwriter.write_reference_config, SimConfig(**SIM)
    path = tmp_path / f"{package}.yaml"
    write(str(path), sim, wc, output_dir=str(tmp_path / "out") + "/",
          **overrides)
    return path


@pytest.mark.parametrize("overrides", [{}, {
    "sw_size": 8, "max_features_num": 32, "zupt_max_feature_dis": 0.01,
    "initial_use_gt": 1, "noise_feature": 1.5e-3, "extra_key": "x"}])
def test_write_reference_config_is_byte_identical(tmp_path, overrides):
    theirs = _writer_config(tmp_path, "jax", **overrides).read_bytes()
    ours = _writer_config(tmp_path, "port", **overrides).read_bytes()
    assert ours == theirs


def _assert_configs_equal(ours, theirs):
    for a, b in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for key in da:
            va, vb = da[key], db[key]
            assert type(va) is type(vb) or np.asarray(va).dtype == np.asarray(
                vb).dtype, (key, va, vb)
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=key)


def test_load_reference_yaml_on_the_writers_config(tmp_path):
    path = str(_writer_config(tmp_path, "port", sw_size=8))
    ours, theirs = pyaml.load_reference_yaml(path), \
        jyaml.load_reference_yaml(path)
    _assert_configs_equal(ours, theirs)
    cfg, cam, fe = ours
    assert cfg.use_larvio and cfg.if_zupt and cfg.sw_size == 8
    assert cfg.ekf_feature_cap == 30 and fe.flag_equalize is True
    assert cam.fx == 98.5 and cam.t_c_b == pytest.approx((0.03, 0.01, 0.0))


def test_load_reference_yaml_on_a_hand_written_config(tmp_path):
    path = tmp_path / "gt.yaml"
    path.write_text(GT_CONFIG)
    ours = pyaml.load_reference_yaml(str(path))
    _assert_configs_equal(ours, jyaml.load_reference_yaml(str(path)))
    cfg, cam, fe = ours
    assert cam.distortion_model == "equidistant" and cam.cx == 320.0
    assert cfg.if_zupt and cfg.static_image_num == 12
    assert fe.flag_equalize is False and cfg.ekf_feature_cap == 32


def test_missing_keys_give_the_defaults(tmp_path):
    path = tmp_path / "min.yaml"
    path.write_text("%YAML:1.0\nsw_size: 9\nintrinsics:\n   fx: 300\n")
    ours = pyaml.load_reference_yaml(str(path))
    _assert_configs_equal(ours, jyaml.load_reference_yaml(str(path)))
    cfg, cam, fe = ours
    assert cfg.sw_size == 9 and cam.fx == 300.0
    assert cam == dataclasses.replace(pyaml.CameraConfig(), fx=300.0)
    assert fe == pyaml.FrontendConfig()
    assert pyaml.load_initial_state(str(path)) is None


def test_load_initial_state_matches_jax(tmp_path):
    assert pyaml.load_initial_state(
        str(_writer_config(tmp_path, "port"))) is None
    path = tmp_path / "gt.yaml"
    path.write_text(GT_CONFIG)
    ours = pyaml.load_initial_state(str(path))
    theirs = jyaml.load_initial_state(str(path))
    assert ours.keys() == theirs.keys()
    assert ours["t"] == theirs["t"]
    for key in ("v", "p", "bg", "ba"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    np.testing.assert_allclose(ours["R"], theirs["R"], rtol=0, atol=1e-15)
