"""Trajectory and object-map figures (matplotlib, offline).

Counterpart of ``orcvio_tpu/eval/plots.py``, the replacement for the
reference's viewer (include/visualization/visualize.hpp, Pangolin, and
the vendored matplotlibcpp): the estimated against the ground-truth
trajectory (top view and per axis), and the quadric object map in bird's
eye view (the MarkerArray of ObjectInitNode.cpp:865). matplotlib is
imported on the first call, with the Agg backend.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(path: str, t, p_est, p_gt=None, title: str = "trajectory"):
    """Top view and per-axis time series; estimate solid, ground truth
    dashed. Returns path."""
    plt = _mpl()
    p_est = np.asarray(p_est)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    axes[0].plot(p_est[:, 0], p_est[:, 1], "-", lw=1.2, label="estimate")
    if p_gt is not None:
        p_gt = np.asarray(p_gt)
        axes[0].plot(p_gt[:, 0], p_gt[:, 1], "--", lw=1.0,
                     label="ground truth")
    axes[0].set_xlabel("x [m]")
    axes[0].set_ylabel("y [m]")
    axes[0].set_aspect("equal", adjustable="datalim")
    axes[0].legend(loc="best", fontsize=8)
    axes[0].set_title(title)
    t = np.asarray(t)
    for k, name in enumerate("xyz"):
        axes[1].plot(t, p_est[:, k], lw=1.0, label=f"est {name}")
        if p_gt is not None:
            axes[1].plot(t, p_gt[:, k], "--", lw=0.8, label=f"gt {name}")
    axes[1].set_xlabel("t [s]")
    axes[1].set_ylabel("position [m]")
    axes[1].legend(loc="best", fontsize=7, ncol=2)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_object_map(path: str, objects: Sequence[dict],
                    gt_objects: Optional[Sequence[dict]] = None,
                    p_est=None, title: str = "object map"):
    """Bird's-eye quadric map: an ellipse at each object's (t, yaw,
    shape), and the trajectory. objects: dicts with t (3,), yaw and shape
    (semi-axes; x and y drawn), the schema of
    eval/objects.py:match_and_mean_iou. Returns path."""
    plt = _mpl()
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(6.5, 6))
    if p_est is not None:
        p_est = np.asarray(p_est)
        ax.plot(p_est[:, 0], p_est[:, 1], "-", lw=0.8, color="gray",
                label="trajectory")

    def draw(objs, color, label):
        for i, ob in enumerate(objs):
            t = np.asarray(ob["t"], float)
            sh = np.asarray(ob["shape"], float)
            ax.add_patch(Ellipse(t[:2], 2 * sh[0], 2 * sh[1],
                                 angle=math.degrees(float(ob["yaw"])),
                                 fill=False, color=color, lw=1.2,
                                 label=label if i == 0 else None))

    draw(objects, "tab:blue", "estimated")
    if gt_objects:
        draw(gt_objects, "tab:green", "ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.autoscale_view()
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
