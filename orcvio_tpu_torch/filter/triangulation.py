"""Batched feature triangulation: two-view initial guess + masked LM.

Counterpart of ``orcvio_tpu/filter/triangulation.py`` (reference:
feature.hpp generateInitialGuess :331, checkMotion :353,
triangulate_position :583): one batched computation over compacted
tracks, a fixed count of damped Gauss-Newton steps with per-feature
accept/reject and a closed-form 3x3 Cramer solve (kernel K6,
``ops/triangulate.py``: one launch on the card, the plain version's loop of
``tri_max_iters`` steps on the CPU). Anchor frame = newest observed clone;
the unknowns are (alpha, beta, rho) = (x/z, y/z, 1/z) in the anchor camera
frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
from ..ops import triangulate as k6
from .tracks import CompactTracks


class TriResult(NamedTuple):
    p_anchor: torch.Tensor  # (F, 3) position in the anchor camera frame
    p_world: torch.Tensor  # (F, 3)
    anchor_slot: torch.Tensor  # (F,) clone slot of the anchor
    valid: torch.Tensor  # (F,) bool
    inv_param: torch.Tensor  # (F, 3) (alpha, beta, rho)


def _gathered_cams(ct: CompactTracks, R_c2w, t_c_w):
    return R_c2w[ct.slot], t_c_w[ct.slot]  # (F, T, 3, 3), (F, T, 3)


def _anchor_index(ct: CompactTracks):
    """Index (into the compact axis) of the newest valid observation."""
    return torch.clamp(ct.n_obs.long() - 1, min=0)


def _at(x, a):
    """x[f, a[f]] over the compact axis 1."""
    return torch.take_along_dim(
        x, a.reshape((-1,) + (1,) * (x.dim() - 1)), dim=1)[:, 0]


def check_motion(ct: CompactTracks, R_c2w, t_c_w, threshold):
    """Parallax check. Ref: Feature::checkMotion (feature.hpp:353);
    threshold < 0 disables it."""
    Rg, tg = _gathered_cams(ct, R_c2w, t_c_w)
    a = _anchor_index(ct)
    z0 = ct.uv[:, 0]
    dir0 = torch.cat([z0, torch.ones_like(z0[:, :1])], dim=1)
    dir0 = dir0 / torch.linalg.norm(dir0, dim=1, keepdim=True)
    dir_w = torch.einsum("fij,fj->fi", Rg[:, 0], dir0)
    trans = _at(tg, a) - tg[:, 0]
    par = torch.sum(trans * dir_w, dim=1)
    ortho = trans - par[:, None] * dir_w
    ok = torch.linalg.norm(ortho, dim=1) > threshold
    return ok | (threshold < 0)


def triangulate(cfg: FilterConfig, ct: CompactTracks, R_c2w, t_c_w,
                p_init_world=None) -> TriResult:
    """Triangulate every row. Ref: Feature::triangulate_position
    (feature.hpp:583).

    p_init_world (F, 3), optional: a world-frame prior point per row (the
    object layer's bbox-derived centre for semantic keypoints). Where it
    is finite and at least 0.2 m in front of the anchor camera, its depth
    there replaces the two-view initial depth. On the card one launch of
    kernel K6 (``ops/triangulate.py``); on the CPU its plain version."""
    return TriResult(*k6.triangulate(
        ct.uv, ct.mask, ct.slot, ct.n_obs, R_c2w, t_c_w, p_init_world,
        huber=cfg.huber_epsilon, iters=cfg.tri_max_iters,
        damping=cfg.tri_initial_damping))
