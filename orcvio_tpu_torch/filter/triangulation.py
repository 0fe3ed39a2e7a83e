"""Batched feature triangulation: two-view initial guess + masked LM.

Counterpart of ``orcvio_tpu/filter/triangulation.py`` (reference:
feature.hpp generateInitialGuess :331, checkMotion :353,
triangulate_position :583): one batched computation over compacted
tracks, a fixed count of damped Gauss-Newton steps with per-feature
accept/reject (a Python loop of ``tri_max_iters`` steps) and a closed-form
3x3 Cramer solve. Anchor frame = newest observed clone; the unknowns are
(alpha, beta, rho) = (x/z, y/z, 1/z) in the anchor camera frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.core import FilterConfig
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


def solve3(A, b):
    """Batched 3x3 Cramer solve."""
    def e(i, j):
        return A[..., i, j]

    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c01 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c02 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    det = e(0, 0) * c00 + e(0, 1) * c01 + e(0, 2) * c02
    det = torch.where(torch.abs(det) > 1e-18, det, 1e-18)
    adj = torch.stack([
        torch.stack([c00, e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
                     e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)], -1),
        torch.stack([c01, e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
                     e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)], -1),
        torch.stack([c02, e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
                     e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)], -1),
    ], dim=-2)
    return torch.einsum("...ij,...j->...i", adj, b) / det[..., None]


def triangulate(cfg: FilterConfig, ct: CompactTracks, R_c2w, t_c_w,
                p_init_world=None) -> TriResult:
    """Triangulate every row. Ref: Feature::triangulate_position
    (feature.hpp:583).

    p_init_world (F, 3), optional: a world-frame prior point per row (the
    object layer's bbox-derived centre for semantic keypoints). Where it
    is finite and at least 0.2 m in front of the anchor camera, its depth
    there replaces the two-view initial depth."""
    dtype = ct.uv.dtype
    Rg, tg = _gathered_cams(ct, R_c2w, t_c_w)
    a = _anchor_index(ct)
    R_a = _at(Rg, a)  # (F, 3, 3)
    t_a = _at(tg, a)  # (F, 3)

    # relative poses anchor -> camera_t
    R_rel = torch.einsum("ftji,fjk->ftik", Rg, R_a)
    t_rel = torch.einsum("ftji,ftj->fti", Rg, t_a[:, None, :] - tg)

    # two-view initial guess in the anchor frame (feature.hpp:331)
    z_anchor = _at(ct.uv, a)
    z_first = ct.uv[:, 0]
    R_fa = R_rel[:, 0]
    t_fa = t_rel[:, 0]
    m = torch.einsum("fij,fj->fi", R_fa, torch.cat(
        [z_anchor, torch.ones_like(z_anchor[:, :1])], 1))
    A0 = m[:, 0] - z_first[:, 0] * m[:, 2]
    A1 = m[:, 1] - z_first[:, 1] * m[:, 2]
    b0 = z_first[:, 0] * t_fa[:, 2] - t_fa[:, 0]
    b1 = z_first[:, 1] * t_fa[:, 2] - t_fa[:, 1]
    denom = A0 * A0 + A1 * A1
    depth = torch.where(denom > 1e-12,
                        (A0 * b0 + A1 * b1) / torch.clamp(denom, min=1e-12), 1.0)
    depth = torch.clamp(depth, 0.1, 1e3)
    if p_init_world is not None:
        h_a = torch.einsum("fji,fj->fi", R_a, p_init_world - t_a)
        prior_ok = torch.all(torch.isfinite(p_init_world), dim=1) & \
            (h_a[:, 2] > 0.2)
        depth = torch.where(prior_ok, torch.clamp(h_a[:, 2], 0.2, 1e3), depth)
    x0 = torch.stack([z_anchor[:, 0], z_anchor[:, 1], 1.0 / depth], dim=1)

    W = torch.cat([R_rel[..., :2], t_rel[..., None]], dim=-1)  # (F, T, 3, 3)
    mask = ct.mask

    def residuals(x):
        ab1 = torch.cat([x[:, :2], torch.ones_like(x[:, :1])], dim=1)
        h = torch.einsum("ftij,fj->fti", R_rel, ab1) + x[:, 2:3, None] * t_rel
        r = h[..., :2] / h[..., 2:3] - ct.uv
        return h, torch.where(mask[..., None], r, 0.0)

    huber = cfg.huber_epsilon
    eye3 = torch.eye(3, dtype=dtype, device=x0.device)
    x = x0
    lam = torch.full_like(x0[:, 0], cfg.tri_initial_damping)
    h, r = residuals(x0)
    cost = torch.sum(r * r, dim=(1, 2))
    for _ in range(cfg.tri_max_iters):
        h3 = h[..., 2:3]
        J = (W[..., :2, :] / h3[..., None]
             - (h[..., :2, None] * W[..., 2:3, :]) / (h3[..., None] ** 2))
        J = torch.where(mask[..., None, None], J, 0.0)
        e = torch.linalg.norm(r, dim=-1)
        w2 = torch.where(e <= huber, 1.0,
                         2.0 * huber / torch.clamp(e, min=1e-12))
        Jw = J * w2[..., None, None]
        A = torch.einsum("ftik,ftil->fkl", Jw, J) + lam[:, None, None] * eye3
        b = torch.einsum("ftik,fti->fk", Jw, r)
        x_new = x - solve3(A, b)
        h_new, r_new = residuals(x_new)
        cost_new = torch.sum(r_new * r_new, dim=(1, 2))
        accept = cost_new < cost
        x = torch.where(accept[:, None], x_new, x)
        cost = torch.where(accept, cost_new, cost)
        h = torch.where(accept[:, None, None], h_new, h)
        r = torch.where(accept[:, None, None], r_new, r)
        lam = torch.where(accept, torch.clamp(lam / 10, min=1e-10),
                          torch.clamp(lam * 10, max=1e12))

    # validity checks (feature.hpp:688-720)
    rho_safe = torch.where(torch.abs(x[:, 2]) > 1e-8, x[:, 2], 1e-8)
    p_anchor = torch.stack([x[:, 0] / rho_safe, x[:, 1] / rho_safe,
                            1.0 / rho_safe], dim=1)
    h, _ = residuals(x)
    depth_all = torch.where(mask, h[..., 2] / rho_safe[:, None], 1.0)
    pos_depth = torch.all(depth_all > 0, dim=1) & (x[:, 2] > 0)
    n_obs = ct.n_obs
    normalized_cost = cost / torch.clamp(2.0 * n_obs * n_obs, min=1.0)
    cost_ok = normalized_cost < 4.7673e-4  # cost_threshold (feature.hpp:58)
    p0 = torch.stack([x0[:, 0] / x0[:, 2], x0[:, 1] / x0[:, 2], 1.0 / x0[:, 2]],
                     dim=1)
    dist_ok = torch.linalg.norm(p_anchor - p0, dim=1) < 5.0
    valid = pos_depth & cost_ok & dist_ok & (n_obs >= 2)

    p_world = torch.einsum("fij,fj->fi", R_a, p_anchor) + t_a
    anchor_slot = _at(ct.slot, a)
    return TriResult(p_anchor=p_anchor, p_world=p_world,
                     anchor_slot=anchor_slot, valid=valid, inv_param=x)
