"""Ingest the reference's OpenCV-FileStorage YAML configs.

Counterpart of ``orcvio_tpu/config/yaml_io.py`` (reference:
``loadParameters`` orcvio.cpp:62-415 and image_processor.cpp:44-113): the
same key names, defaults and conversions, producing the typed
FilterConfig, CameraConfig and FrontendConfig. The JAX package reads the
file with ``cv2.FileStorage``; the port has its own reader for the subset
of OpenCV's YAML that the reference's configs use: the ``%YAML:1.0``
header, ``key: value`` scalars and quoted strings, nested maps
(``intrinsics:``, ``distortion_coeffs:``), ``!!opencv-matrix`` nodes
whose ``data: [...]`` may span several lines, block sequences of scalars
(``- item`` lines), comments and blank lines. Scalars keep FileStorage's
types: an integer, a real or a string, and a number read as a string (or
a string as a number) gives 0 (or "").
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..math import quat
from .core import FilterConfig


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    distortion_model: str = "radtan"  # "radtan" | "equidistant"
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0)
    # T_cam_imu: camera_T_imu (Kalibr convention, takes imu-frame vectors to
    # camera frame), orcvio.cpp:229-247
    R_b2c: tuple = tuple(map(tuple, np.eye(3)))
    t_c_b: tuple = (0.0, 0.0, 0.0)

    @property
    def K(self):
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1.0]])


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    pyramid_levels: int = 2
    patch_size: int = 21
    fast_threshold: int = 30
    max_iteration: int = 30
    track_precision: float = 0.01
    ransac_threshold: float = 1.0
    max_features_num: int = 200
    min_distance: int = 20
    flag_equalize: bool = True
    pub_frequency: float = 10.0


# ---------------------------------------------------------------------------
# The FileStorage subset
# ---------------------------------------------------------------------------

_INT = re.compile(r"[+-]?\d+$")
_MAT_DTYPES = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
               "i": np.int32, "f": np.float32, "d": np.float64}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    """A scalar as FileStorage types it: int, float or str."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text


def _matrix(node: dict) -> np.ndarray:
    dtype = _MAT_DTYPES[str(node.get("dt", "d"))[0]]
    data = np.asarray(node.get("data", []), np.float64).astype(dtype)
    return data.reshape(int(node["rows"]), int(node["cols"]))


def _flow_seq(text: str, lines, i):
    """A [...] sequence starting in `text`, continued on lines[i:] until its
    bracket closes. Returns (list of scalars, next line index)."""
    while text.count("[") > text.count("]"):
        if i >= len(lines):
            raise ValueError("unterminated [ sequence")
        text += " " + lines[i][1]
        i += 1
    inner = text.strip()[1:-1]
    return [_scalar(t.strip()) for t in inner.split(",") if t.strip()], i


def _block_seq(lines, i, indent):
    """A block sequence of scalars ("- item" lines at `indent`) from
    lines[i:]. Returns (list, next line index)."""
    out = []
    while i < len(lines) and lines[i][0] == indent and \
            lines[i][1].startswith("- "):
        out.append(_scalar(lines[i][1][2:].strip()))
        i += 1
    return out, i


def _parse_map(lines, i, indent):
    """Keys at exactly `indent` from lines[i:]; returns (dict, next i)."""
    out = {}
    while i < len(lines):
        ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"unexpected indentation: {text!r}")
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value': {text!r}")
        key, rest = key.strip(), rest.strip()
        i += 1
        tag = ""
        if rest.startswith("!!"):
            tag, _, rest = rest.partition(" ")
            rest = rest.strip()
        if rest.startswith("["):
            value, i = _flow_seq(rest, lines, i)
        elif rest:
            value = _scalar(rest)
        elif i < len(lines) and lines[i][0] > ind and \
                lines[i][1].startswith("["):
            value, i = _flow_seq(lines[i][1], lines, i + 1)
        elif i < len(lines) and lines[i][0] >= ind and \
                lines[i][1].startswith("- "):
            value, i = _block_seq(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] > ind:
            value, i = _parse_map(lines, i, lines[i][0])
        else:
            value = {}
        out[key] = _matrix(value) if tag == "!!opencv-matrix" else value
    return out, i


def read_filestorage(path: str) -> dict:
    """The top-level map of an OpenCV YAML file, scalars typed as
    FileStorage types them and ``!!opencv-matrix`` nodes as arrays."""
    lines = []
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw.rstrip("\r\n")).rstrip()
            body = line.lstrip()
            if not body or body.startswith("%") or body in ("---", "..."):
                continue
            lines.append((len(line) - len(body), body))
    if not lines:
        return {}
    tree, i = _parse_map(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{path}: cannot parse {lines[i][1]!r}")
    return tree


def _real(value) -> float:
    """FileNode::real(): a number as a float, anything else 0."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return 0.0


def _get(fs: dict, key, default):
    if key not in fs:
        return default
    value = fs[key]
    if isinstance(default, bool):
        return bool(int(_real(value)))
    if isinstance(default, int):
        return int(_real(value))
    if isinstance(default, float):
        return float(_real(value))
    if isinstance(default, str):
        return value if isinstance(value, str) else ""
    return default


def load_reference_yaml(path: str):
    """Parse a reference config file -> (FilterConfig, CameraConfig,
    FrontendConfig)."""
    fs = read_filestorage(path)
    T = fs.get("T_cam_imu")
    if not isinstance(T, np.ndarray):
        T = np.eye(4)
    R_b2c = T[:3, :3]
    # t of T_cam_imu maps imu->cam: p_c = R p_b + t, so the camera position
    # in the imu frame is t_c_b = -R^T t (orcvio.cpp:233-238)
    t_c_b = -R_b2c.T @ T[:3, 3]
    intr = fs.get("intrinsics", {})
    dist = fs.get("distortion_coeffs", {})

    def node_val(parent, name, default):
        if not isinstance(parent, dict) or name not in parent:
            return default
        return float(_real(parent[name]))

    cam = CameraConfig(
        width=_get(fs, "resolution_width", 752),
        height=_get(fs, "resolution_height", 480),
        fx=node_val(intr, "fx", 458.654),
        fy=node_val(intr, "fy", 457.296),
        cx=node_val(intr, "cx", 367.215),
        cy=node_val(intr, "cy", 248.375),
        distortion_model=_get(fs, "distortion_model", "radtan"),
        dist_coeffs=(node_val(dist, "k1", 0.0), node_val(dist, "k2", 0.0),
                     node_val(dist, "p1", 0.0), node_val(dist, "p2", 0.0)),
        R_b2c=tuple(map(tuple, R_b2c)),
        t_c_b=tuple(t_c_b),
    )
    fe = FrontendConfig(
        pyramid_levels=_get(fs, "pyramid_levels", 2),
        patch_size=_get(fs, "patch_size", 21),
        fast_threshold=_get(fs, "fast_threshold", 30),
        max_iteration=_get(fs, "max_iteration", 30),
        track_precision=_get(fs, "track_precision", 0.01),
        ransac_threshold=_get(fs, "ransac_threshold", 1.0),
        max_features_num=_get(fs, "max_features_num", 200),
        min_distance=_get(fs, "min_distance", 20),
        flag_equalize=_get(fs, "flag_equalize", True),
        pub_frequency=_get(fs, "pub_frequency", 10.0),
    )
    cfg = FilterConfig(
        sw_size=_get(fs, "sw_size", 20),
        max_features=fe.max_features_num,
        max_track_len=_get(fs, "max_track_len", 6),
        min_track_len=_get(fs, "least_observation_number", 3),
        use_larvio=_get(fs, "use_larvio_flag", False),
        use_left_perturbation=_get(fs, "use_left_perturbation_flag", True),
        use_closed_form_cov_prop=_get(fs, "use_closed_form_cov_prop_flag",
                                      False),
        if_fej=_get(fs, "if_FEJ", False),
        estimate_extrinsic=_get(fs, "estimate_extrin", False),
        estimate_td=_get(fs, "estimate_td", False),
        calib_imu=_get(fs, "calib_imu_instrinsic", False),
        prediction_only=_get(fs, "prediction_only_flag", False),
        if_zupt=_get(fs, "if_ZUPT_valid", False),
        gyro_noise=_get(fs, "noise_gyro", 0.004),
        acc_noise=_get(fs, "noise_acc", 0.08),
        gyro_bias_noise=_get(fs, "noise_gyro_bias", 2e-6),
        acc_bias_noise=_get(fs, "noise_acc_bias", 4e-5),
        observation_noise=_get(fs, "noise_feature", 0.035),
        init_cov_orientation=_get(fs, "initial_covariance_orientation", 4e-4),
        init_cov_velocity=_get(fs, "initial_covariance_velocity", 0.25),
        init_cov_position=_get(fs, "initial_covariance_position", 1.0),
        init_cov_gyro_bias=_get(fs, "initial_covariance_gyro_bias", 4e-4),
        init_cov_acc_bias=_get(fs, "initial_covariance_acc_bias", 0.01),
        init_cov_extrin_rot=_get(fs, "initial_covariance_extrin_rot", 3e-4),
        init_cov_extrin_trans=_get(fs, "initial_covariance_extrin_trans",
                                   2.5e-5),
        td=_get(fs, "td", 0.0),
        zupt_max_feature_dis=_get(fs, "zupt_max_feature_dis", 2e-3),
        position_std_threshold=_get(fs, "position_std_threshold", 8.0),
        tri_translation_threshold=_get(fs, "feature_translation_threshold",
                                       0.2),
        static_image_num=_get(fs, "static_image_num", 20),
        max_grid_features=_get(fs, "max_features_in_one_grid", 0),
        feature_idp_dim=_get(fs, "feature_idp_dim", 3),
        # EKF-SLAM capacity: the reference caps in-state features at
        # max_features_in_one_grid * aug_grid_rows * aug_grid_cols
        # (orcvio.cpp:2286); the static capacity is bounded at 48 blocks
        ekf_feature_cap=min(_get(fs, "max_features_in_one_grid", 0)
                            * _get(fs, "aug_grid_rows", 5)
                            * _get(fs, "aug_grid_cols", 6), 48),
    )
    return cfg, cam, fe


def load_initial_state(path: str):
    """GT initial state from a reference YAML (initial_use_gt,
    orcvio.cpp:123).

    Returns None unless the file sets initial_use_gt; otherwise a dict with
    t, R (from initial_quat, Hamilton [x y z w]), v, p, bg, ba as numpy
    arrays."""
    fs = read_filestorage(path)
    if not _get(fs, "initial_use_gt", False):
        return None

    def vec(key, n):
        return np.asarray(fs[key], np.float64).reshape(-1)[:n]

    R = quat.to_rotation(torch.as_tensor(vec("initial_quat", 4))).numpy()
    return dict(t=float(_get(fs, "initial_state_time", 0.0)), R=R,
                v=vec("initial_vel", 3), p=vec("initial_pos", 3),
                bg=vec("initial_bg", 3), ba=vec("initial_ba", 3))
