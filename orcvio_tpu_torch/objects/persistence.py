"""Object-map text persistence, format-compatible with the reference.

The port's copy of ``orcvio_tpu/objects/persistence.py`` (numpy only).

Ref: ``save_object_state_to_file`` (ObjectState.h:40-46, ObjectState.cpp:42)
and the per-stage dumps the ROS mapper writes
(initial_state_%d.txt / after_LM_object_state_%d.txt, ObjectInitNode.cpp:986).
"""
from __future__ import annotations

import re

import numpy as np


def save_object_state(path_format: str, object_id: int, object_class: str,
                      wTq: np.ndarray, kps_global: np.ndarray,
                      ellipsoid_shape: np.ndarray, timestamps):
    path = path_format % object_id if "%d" in path_format else path_format
    with open(path, "w") as f:
        f.write(f"object id:\n{object_id}\n")
        f.write(f"object class:\n{object_class}\n")
        f.write("wTq:\n")
        for row in np.asarray(wTq):
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
        f.write("keypoints in global frame:\n")
        for row in np.asarray(kps_global):
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
        f.write("ellipsoid shape:\n")
        for v in np.asarray(ellipsoid_shape).reshape(-1):
            f.write(f"{v:.9g}\n")
        f.write("observation timestamps:\n")
        f.write(" ".join(f"{t:.3f}" for t in timestamps))
    return path


def load_object_state(path: str) -> dict:
    with open(path) as f:
        txt = f.read()

    def block(name, nxt):
        m = re.search(rf"{name}:\n(.*?)(?:\n{nxt}:|\Z)", txt, re.S)
        return m.group(1).strip()

    oid = int(block("object id", "object class"))
    cls = block("object class", "wTq")
    wTq = np.asarray([[float(v) for v in row.split()] for row in block("wTq", "keypoints in global frame").splitlines()])
    kps = np.asarray(
        [[float(v) for v in row.split()] for row in block("keypoints in global frame", "ellipsoid shape").splitlines()]
    )
    shape = np.asarray([float(v) for v in block("ellipsoid shape", "observation timestamps").split()])
    ts = [float(v) for v in block("observation timestamps", "NONE").split()]
    return dict(object_id=oid, object_class=cls, wTq=wTq, kps_global=kps, ellipsoid_shape=shape, timestamps=ts)
