"""The front-end tracker: KLT + ORB gate + RANSAC + gridded re-detection.

Counterpart of ``orcvio_tpu/frontend/tracker.py`` (reference:
ImageProcessor::processImage, image_processor.cpp:130), with the same
documented differences from the reference's control flow: no first-frame
special case, new detections enter the track table at once, and gyro-aided
prediction uses the exact relative rotation R_b2c exp(-mean_gyro dt) R_b2c^T
on normalized coordinates.

A frame step keeps fixed capacities and masks and makes no host
synchronisation: placement writes through index tensors with a spill row
instead of boolean indexing. Whether a frame re-detects is decided on the
host from the frame index, as the JAX package's ``lax.cond`` decides it.

The stages run inside spans (``utils/profiling.py:span``): equalize,
pyramid, klt, detect, orb, undistort, ransac and place, each entered once
a frame. ``TrackerOutput`` carries the frame's gate counts as 0-d int32
tensors, never read on the host here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import no_tf32, resolve_device
from ..tree import Tree, tree_stack
from ..math import so3
from ..utils.profiling import span
from . import orb
from .detect import detect_grid
from .image import build_pyramid, clahe, equalize_hist
from .klt import forward_backward_track, prepare_pyramid
from .ransac import ransac_fundamental
from .undistort import normalized_to_pixel, undistort_pixels


class TrackerConfig(NamedTuple):
    height: int = 480
    width: int = 752
    pyramid_levels: int = 3
    patch_size: int = 15
    klt_iters: int = 10
    orb_threshold: int = 58  # Hamming gate (image_processor.cpp:463)
    ransac_thresh: float = 3e-5  # squared Sampson, normalized coords
    capacity: int = 200  # max tracked features (max_features_num)
    grid_rows: int = 8
    grid_cols: int = 10
    per_cell: int = 3
    min_distance: float = 20.0
    detect_every: int = 1  # re-detect every Nth frame; 2 = the reference's
    # pub_frequency cadence (image_processor.cpp:197)
    # "clahe": image.clahe (the reference's cv::CLAHE); any other true value:
    # equalize_hist's default "poly" mode, as the JAX package; False: none
    equalize: bool | str = True
    K: tuple = (458.654, 457.296, 367.215, 248.375)  # fx fy cx cy
    dist_model: str = "radtan"
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0)


def level_shapes(tc: TrackerConfig):
    """(H, W) of each pyramid level, as build_pyramid produces them."""
    shapes = [(tc.height, tc.width)]
    for _ in range(tc.pyramid_levels - 1):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


@dataclass
class TrackerState(Tree):
    _static = ("rng",)

    pyr: tuple  # previous prepared pyramid (tuple of AlignedImage)
    xy: torch.Tensor  # (N, 2) previous pixel positions
    uvn: torch.Tensor  # (N, 2) previous normalized coords
    desc: torch.Tensor  # (N, 8) int64 descriptor words (32-bit values)
    fid: torch.Tensor  # (N,) int32, -1 = free
    t: torch.Tensor  # previous frame time
    next_id: torch.Tensor  # int32
    rng: torch.Generator  # RANSAC sampling; advanced in place by each frame

    @classmethod
    def create(cls, tc: TrackerConfig, dtype=torch.float32, seed: int = 0,
               device=None):
        device = resolve_device(device)
        levels = [torch.zeros(s, dtype=dtype, device=device)
                  for s in level_shapes(tc)]
        N = tc.capacity
        return cls(
            pyr=prepare_pyramid(levels),
            xy=torch.zeros((N, 2), dtype=dtype, device=device),
            uvn=torch.zeros((N, 2), dtype=dtype, device=device),
            desc=torch.zeros((N, 8), dtype=torch.int64, device=device),
            fid=torch.full((N,), -1, dtype=torch.int32, device=device),
            t=torch.zeros((), dtype=dtype, device=device),
            next_id=torch.zeros((), dtype=torch.int32, device=device),
            rng=torch.Generator(device=device).manual_seed(seed),
        )


def stack_tracker_states(states):
    """B tracker states as one batched state for the batched replay: the
    tensors stacked (tree.py:tree_stack), the B generators kept as
    a tuple, since each stream draws its own RANSAC noise outside vmap."""
    return tree_stack([s.replace(rng=None) for s in states]).replace(
        rng=tuple(s.rng for s in states))


class TrackerOutput(NamedTuple):
    fids: torch.Tensor  # (N,) int32
    uvs: torch.Tensor  # (N, 2) normalized, undistorted
    uv_vels: torch.Tensor  # (N, 2)
    meas_mask: torch.Tensor  # (N,)
    # the frame's gate counts, 0-d int32: tracks entering LK, their
    # forward-backward survivors, the ORB gate's survivors (the tracks
    # entering RANSAC), RANSAC's inliers (the tracks kept) and the
    # detections placed in free rows
    n_lk_in: torch.Tensor
    n_lk_ok: torch.Tensor
    n_orb_ok: torch.Tensor
    n_inliers: torch.Tensor
    n_placed: torch.Tensor


def _predict(tc: TrackerConfig, uvn, R_p2c):
    """Rotation-compensated prediction in normalized coords -> pixels."""
    h = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    rot = torch.einsum("ij,nj->ni", R_p2c, h)
    pred_n = rot[..., :2] / torch.clamp(rot[..., 2:3], min=0.1)
    return normalized_to_pixel(pred_n, tc.K)


def _count(mask):
    """The true entries of a mask, as a 0-d int32 tensor."""
    return torch.sum(mask).to(torch.int32)


def _set_rows(base, rows, values):
    """base with base[rows[i]] = values[i]; rows == len(base) is dropped."""
    spill = torch.cat([base, base[:1]])
    return spill.index_copy(0, rows, values)[:-1]


def process_frame(tc: TrackerConfig, ts: TrackerState, img, t, mean_gyro,
                  R_b2c, frame_idx=None, ransac_gumbel=None):
    """One camera frame -> (new TrackerState, TrackerOutput).

    img: (H, W) float [0, 255]; mean_gyro: (3,) body rate over the frame
    gap; frame_idx: Python int; with tc.detect_every > 1, re-detection runs
    only where frame_idx % detect_every == 0. ransac_gumbel: optional
    (128, 8, N) Gumbel noise for the RANSAC draw (else from ts.rng).
    """
    dtype, device = img.dtype, img.device
    if img.is_cuda:
        no_tf32()
    with span("frontend.equalize"):
        if tc.equalize == "clahe":
            img = clahe(img)
        elif tc.equalize:
            img = equalize_hist(img)
    with span("frontend.pyramid"):
        pyr = prepare_pyramid(build_pyramid(img, tc.pyramid_levels))
    N = tc.capacity
    dt = t - ts.t
    have_prev = ts.fid >= 0

    with span("frontend.klt"):
        # --- gyro-aided prediction + forward/backward KLT ---
        dR_b = so3.exp(mean_gyro * dt)
        R_p2c = R_b2c @ dR_b.T @ R_b2c.T
        pred_xy = _predict(tc, ts.uvn, R_p2c)
        pred_xy = torch.where(have_prev[:, None], pred_xy, ts.xy)
        klt = forward_backward_track(ts.pyr, pyr, ts.xy, pred_xy,
                                     patch=tc.patch_size, iters=tc.klt_iters)
        tracked = have_prev & klt.ok
        n_lk_ok = _count(tracked)

    with span("frontend.detect"):
        # --- re-detection candidates, suppressed near tracked positions ---
        if tc.detect_every <= 1 or frame_idx is None \
                or frame_idx % tc.detect_every == 0:
            det_xy, det_sc, det_ok = detect_grid(
                img, tc.per_cell, tc.grid_rows, tc.grid_cols,
                occupied_xy=klt.xy, occupied_mask=tracked,
                min_distance=tc.min_distance)
        else:
            n_cand = tc.per_cell * tc.grid_rows * tc.grid_cols
            det_xy = torch.zeros((n_cand, 2), dtype=dtype, device=device)
            det_sc = torch.zeros((n_cand,), dtype=dtype, device=device)
            det_ok = torch.zeros((n_cand,), dtype=torch.bool, device=device)
        det_order = torch.argsort(-det_sc, stable=True)  # best first
        det_xy_s = det_xy[det_order]
        det_ok_s = det_ok[det_order]

    with span("frontend.orb"):
        # --- ORB descriptors: one pass over tracked positions + detections ---
        desc_cat = orb.describe(pyr[0], torch.cat([klt.xy, det_xy_s], dim=0))
        new_desc = desc_cat[:N]
        det_desc = desc_cat[N:]
        tracked = tracked & (orb.hamming(ts.desc, new_desc)
                             <= tc.orb_threshold)
        n_orb_ok = _count(tracked)

    with span("frontend.undistort"):
        # --- undistort to normalized coords ---
        uvn_all = undistort_pixels(
            torch.cat([klt.xy, det_xy_s], dim=0), tc.K, tc.dist_model,
            tc.dist_coeffs).to(dtype)
        uvn_new, det_uvn = uvn_all[:N], uvn_all[N:]

    with span("frontend.ransac"):
        # --- RANSAC gate on normalized coords ---
        inl, _F = ransac_fundamental(ts.uvn, uvn_new, tracked,
                                     gumbel=ransac_gumbel, generator=ts.rng,
                                     thresh=tc.ransac_thresh)
        tracked = tracked & inl

    with span("frontend.place"):
        # --- place detections into free rows: strongest claim first ---
        free = ~tracked
        free_rank = torch.cumsum(free, dim=0) - 1
        det_rank = torch.cumsum(det_ok_s, dim=0) - 1
        place = det_ok_s & (det_rank < torch.sum(free))
        ar = torch.arange(N, device=device)
        rank_to_row = _set_rows(
            torch.zeros(N, dtype=torch.int64, device=device),
            torch.where(free, free_rank, N), ar)
        target_row = rank_to_row[torch.clamp(det_rank, 0, N - 1)]
        rows = torch.where(place, target_row, N)

        xy = _set_rows(torch.where(tracked[:, None], klt.xy, 0.0), rows,
                       det_xy_s)
        uvn = _set_rows(torch.where(tracked[:, None], uvn_new, 0.0), rows,
                        det_uvn)
        new_ids = ts.next_id + torch.cumsum(place, dim=0).to(torch.int32) - 1
        fid = _set_rows(torch.where(tracked, ts.fid, -1), rows, new_ids)
        next_id = ts.next_id + torch.sum(place).to(torch.int32)
        desc = _set_rows(torch.where(tracked[:, None], new_desc, 0), rows,
                         det_desc)

        # velocities for tracked features (feature_msg u_vel/v_vel)
        dt_safe = torch.clamp(dt, min=1e-6)
        vel = torch.where(tracked[:, None], (uvn - ts.uvn) / dt_safe, 0.0)

        out = TrackerOutput(fids=fid, uvs=uvn, uv_vels=vel,
                            meas_mask=fid >= 0, n_lk_in=_count(have_prev),
                            n_lk_ok=n_lk_ok, n_orb_ok=n_orb_ok,
                            n_inliers=_count(tracked), n_placed=_count(place))
    new_state = dataclasses.replace(
        ts, pyr=pyr, xy=xy, uvn=uvn, desc=desc, fid=fid,
        t=torch.as_tensor(t, dtype=dtype, device=device), next_id=next_id)
    return new_state, out
