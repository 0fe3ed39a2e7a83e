"""Ingest the reference's object shape-prior configs (object_feat_*.yaml).

Counterpart of ``orcvio_tpu/config/objects_yaml.py``. Same schema as
``config/object_feat_{all,unity,kitti,erl,mesa}.yaml``: per class
keypoints_num, object_keypoints_mean (a flat 3K list in coordinate-major
order: all x, all y, all z), object_mean_shape (the ellipsoid's
semi-axes), aliases, marker_color. The JAX package reads the file with
PyYAML; the port reads it with its own reader (``yaml_io.read_filestorage``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .yaml_io import read_filestorage


@dataclasses.dataclass(frozen=True)
class ObjectClassConfig:
    name: str
    keypoints_num: int
    keypoints_mean: Tuple[Tuple[float, ...], ...]  # (K, 3)
    mean_shape: Tuple[float, float, float]
    aliases: Tuple[str, ...] = ()
    marker_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def keypoints_mean_np(self) -> np.ndarray:
        return np.asarray(self.keypoints_mean)

    @property
    def mean_shape_np(self) -> np.ndarray:
        return np.asarray(self.mean_shape)


def load_object_config(path: str) -> Dict[str, ObjectClassConfig]:
    """Parse object_feat_*.yaml -> {class name (and each alias): config}."""
    raw = read_filestorage(path)
    out: Dict[str, ObjectClassConfig] = {}
    for name, spec in raw["object_classes"].items():
        k = int(spec["keypoints_num"])
        flat = np.asarray(spec["object_keypoints_mean"], dtype=np.float64)
        kps = flat.reshape(3, k).T  # coordinate-major: (3, K) -> (K, 3)
        aliases = spec.get("aliases") or ()
        cfg = ObjectClassConfig(
            name=name,
            keypoints_num=k,
            keypoints_mean=tuple(map(tuple, kps)),
            mean_shape=tuple(np.asarray(spec["object_mean_shape"],
                                        dtype=np.float64)),
            aliases=tuple(str(a) for a in aliases),
            marker_color=tuple(spec.get("marker_color", (0.0, 0.0, 0.0))),
        )
        out[name] = cfg
        for a in cfg.aliases:
            out[a] = cfg
    return out


def scale_mean_shape(kps, dims, axis_map=(0, 1, 2)):
    """Scale canonical keypoints per axis to metric object dimensions (the
    mean-shape tooling, python_scripts/process_sem_kps/
    scale_mean_shape_*.py): the keypoints' extents become the class's
    average (length, width, height). kps (K, 3); dims (3,) target extents
    per output axis; axis_map[i] names the keypoint column of output axis i
    (the car stores width on x, length on y, height on z: axis_map=(1, 0,
    2) with dims=(L, W, H)).

    Returns (kps_scaled (K, 3), scales (3,) per keypoint column)."""
    kps = np.asarray(kps, np.float64)
    dims = np.asarray(dims, np.float64)
    extents = kps.max(axis=0) - kps.min(axis=0)
    scales = np.ones(3)
    for out_axis, col in enumerate(axis_map):
        scales[col] = dims[out_axis] / max(extents[col], 1e-9)
    return kps * scales, scales
