"""Staged replay: the image and IMU stream resident on the device, one frame
step after another.

Counterpart of ``orcvio_tpu/eval/staged.py``. The JAX package compiles the
whole replay into one ``lax.scan``; here a Python loop runs the frame steps
over device-resident uint8 images, and nothing inside the loop waits for
the device. ``make_e2e_replay`` runs the tracker and then ``vio_step``
(static init, then the filter) per frame; ``make_tracker_scan`` runs the
front end alone. After initialization the loop reads nothing back.
``make_batched_e2e_replay`` runs B streams over one shared sequence as one
batch, ``torch.func.vmap`` of the same frame step, each frame's tracker
inside the span ``replay.track`` and its filter inside ``replay.vio``
(``utils/profiling.py:span``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig
from ..filter.pipeline import FrameInput, build_chi2_table
from ..frontend.ransac import RANSAC_HYPOTHESES, draw_gumbel
from ..frontend.tracker import TrackerConfig, TrackerState, process_frame
from ..utils.profiling import span
from ..vio import VioState, batched_vio_step, vio_step


class StagedInputs(NamedTuple):
    images: torch.Tensor  # (T, H, W) uint8, device-resident
    frame_ts: torch.Tensor  # (T,)
    imu_t: torch.Tensor  # (T, S)
    imu_gyro: torch.Tensor  # (T, S, 3)
    imu_acc: torch.Tensor  # (T, S, 3)
    imu_mask: torch.Tensor  # (T, S) bool


def stage_sequence(images_u8: np.ndarray, frame_ts, imu_t, imu_gyro, imu_acc,
                   imu_mask, dtype=torch.float32, device=None) -> StagedInputs:
    """Upload the sequence once (images stay uint8 to halve device traffic)."""
    device = resolve_device(device)

    def put(x, dt):
        x = np.require(x, requirements="W")  # torch wants writable arrays
        return torch.as_tensor(x).to(device=device, dtype=dt)

    return StagedInputs(
        images=put(images_u8, torch.uint8),
        frame_ts=put(frame_ts, dtype),
        imu_t=put(imu_t, dtype),
        imu_gyro=put(imu_gyro, dtype),
        imu_acc=put(imu_acc, dtype),
        imu_mask=put(imu_mask, torch.bool),
    )


# the tracker's gate counts the replays pass through (TrackerOutput)
COUNTS = ("n_lk_in", "n_lk_ok", "n_orb_ok", "n_inliers", "n_placed")


def _track(tc: TrackerConfig, ts: TrackerState, staged: StagedInputs, k: int,
           R_b2c, dtype, gumbel=None):
    """Frame k through the front end: (tracker state, FrameInput, the
    tracker's gate counts as a dict of 0-d tensors). The tracker runs in
    R_b2c's dtype, the FrameInput is in `dtype`; gumbel: the frame's (128,
    8, N) RANSAC noise, else drawn from ts.rng."""
    tdt = R_b2c.dtype
    im = staged.imu_mask[k]
    denom = torch.clamp(torch.sum(im), min=1)
    mean_gyro = torch.sum(torch.where(im[:, None], staged.imu_gyro[k], 0.0),
                          dim=0) / denom
    ts, tout = process_frame(
        tc, ts, staged.images[k].to(tdt), staged.frame_ts[k].to(tdt),
        mean_gyro.to(tdt), R_b2c, frame_idx=k, ransac_gumbel=gumbel)
    frame = FrameInput(
        t=staged.frame_ts[k], imu_t=staged.imu_t[k],
        imu_gyro=staged.imu_gyro[k], imu_acc=staged.imu_acc[k],
        imu_mask=staged.imu_mask[k], fids=tout.fids,
        uvs=tout.uvs.to(dtype), uv_vels=tout.uv_vels.to(dtype),
        meas_mask=tout.meas_mask)
    return ts, frame, {n: getattr(tout, n) for n in COUNTS}


def _stack_outs(outs, inits, counts, dim=0):
    """The replays' outs: per-frame FrameOutputs, flags and the tracker's
    counts stacked on `dim`."""
    stacked = {name: torch.stack([getattr(o, field) for o in outs], dim)
               for name, field in (("p", "p"), ("R", "R"), ("v", "v"),
                                   ("n_upd", "n_update_features"),
                                   ("zupt", "zupt"),
                                   ("n_ekf", "n_ekf_features"))}
    stacked["initialized"] = torch.stack(inits, dim)
    for n in COUNTS:
        stacked[n] = torch.stack([c[n] for c in counts], dim)
    return stacked


def make_e2e_replay(cfg: FilterConfig, tc: TrackerConfig, R_b2c, t_c_b,
                    dtype=torch.float32, device=None):
    """Build replay(tracker_state, vio_state, staged, ransac_gumbel=None,
    frames=None) -> ((tracker_state, vio_state), outs).

    outs: dict of per-frame stacked "p", "R", "v", "n_upd", "zupt" (as
    the JAX package's), "initialized" (the filter's flag after the
    frame: true from the frame static init ends on), "n_ekf" (in-state
    features after the frame) and the tracker's gate counts (``COUNTS``).
    frames: a range of frame indices to run (default: all); the frame index
    sets the detection cadence, as in the JAX package's scan. ransac_gumbel:
    optional per-frame (T, 128, 8, N) RANSAC noise (tests pass the JAX
    package's draws). The front end, and so the tracker state, runs in
    float32 on the card, whose LK kernels take float32 only, and in dtype
    on the CPU. Timestamps are used as given; a caller with absolute
    epochs rebases them first, since float32 cannot hold them.
    """
    device = resolve_device(device)
    no_tf32()
    chi2 = build_chi2_table(cfg, dtype, device)
    R_b2c, t_c_b, R_trk = _extrinsics(R_b2c, t_c_b, dtype, device)

    def replay(tracker_state: TrackerState, vio_state: VioState,
               staged: StagedInputs, ransac_gumbel=None, frames=None):
        # pin the camera-imu extrinsics into the filter state, so a caller
        # cannot run with the default identity extrinsics by accident
        vs = vio_state.replace(filter=vio_state.filter.replace(
            R_b2c=R_b2c, t_c_b=t_c_b))
        ts = tracker_state
        outs, inits, counts = [], [], []
        for k in (range(staged.images.shape[0]) if frames is None else frames):
            ts, frame, c = _track(tc, ts, staged, k, R_trk, dtype,
                                  None if ransac_gumbel is None
                                  else ransac_gumbel[k])
            vs, fout = vio_step(cfg, vs, frame, chi2)
            outs.append(fout)
            inits.append(vs.filter.initialized)
            counts.append(c)
        return (ts, vs), _stack_outs(outs, inits, counts)

    return replay


def _extrinsics(R_b2c, t_c_b, dtype, device):
    """(R_b2c, t_c_b) in the filter's dtype and R_b2c in the tracker's:
    float32 on the card (the LK kernels take float32 only), else dtype."""
    R = torch.as_tensor(np.asarray(R_b2c)).to(device=device, dtype=dtype)
    t = torch.as_tensor(np.asarray(t_c_b)).to(device=device, dtype=dtype)
    return R, t, R.to(torch.float32 if device.type == "cuda" else dtype)


def make_batched_e2e_replay(cfg: FilterConfig, tc: TrackerConfig, R_b2c,
                            t_c_b, dtype=torch.float32, device=None):
    """make_e2e_replay for B streams at once on one card, over one shared
    staged sequence: the serving configuration, the counterpart of the JAX
    package's ``jax.vmap(replay, in_axes=(0, 0, None))``. Build
    replay(tracker_states, vio_states, staged, ransac_gumbel=None,
    frames=None) -> ((tracker_states, vio_states), outs).

    tracker_states: ``stack_tracker_states`` of B tracker states (each
    stream draws its RANSAC noise from its own generator, so row b with
    seed s is the single-stream replay with seed s); vio_states:
    ``tree_stack`` of B VioStates. Each frame runs torch.func.vmap of the
    single-stream tracker step, then ``batched_vio_step``; the staged
    sequence is shared (closed over, not batched), so the frame's image
    and pyramid are read once for the batch. outs as make_e2e_replay's,
    (B, T, ...). ransac_gumbel: optional (B, T, 128, 8, N) RANSAC noise,
    each row's draws.
    """
    device = resolve_device(device)
    no_tf32()
    chi2 = build_chi2_table(cfg, dtype, device)
    R_b2c, t_c_b, R_trk = _extrinsics(R_b2c, t_c_b, dtype, device)

    def replay(tracker_states: TrackerState, vio_states: VioState,
               staged: StagedInputs, ransac_gumbel=None, frames=None):
        B = vio_states.filter.P.shape[0]
        vs = vio_states.replace(filter=vio_states.filter.replace(
            R_b2c=R_b2c.expand(B, 3, 3), t_c_b=t_c_b.expand(B, 3)))
        rngs = tracker_states.rng
        ts = tracker_states.replace(rng=None)
        shape = (RANSAC_HYPOTHESES, 8, tc.capacity)
        outs, inits, counts = [], [], []
        for k in (range(staged.images.shape[0]) if frames is None else frames):
            with span("replay.track"):
                if ransac_gumbel is None:
                    gumbel = torch.stack([draw_gumbel(shape, g, R_trk.dtype,
                                                      device) for g in rngs])
                else:
                    gumbel = ransac_gumbel[:, k]
                ts, frame, c = torch.func.vmap(
                    lambda st, g: _track(tc, st, staged, k, R_trk, dtype, g))(
                    ts, gumbel)
            with span("replay.vio"):
                vs, fout = batched_vio_step(cfg, vs, frame, chi2)
            outs.append(fout)
            inits.append(vs.filter.initialized)
            counts.append(c)
        return (ts.replace(rng=rngs), vs), _stack_outs(outs, inits, counts, 1)

    return replay


def make_tracker_scan(tc: TrackerConfig, R_b2c, dtype=torch.float32,
                      device=None):
    """Build scan(tracker_state, staged, ransac_gumbel=None) ->
    (final state, FrameInput of (T, ...) tensors).

    Runs only the front end over the staged image stream. ransac_gumbel:
    optional per-frame (T, 128, 8, N) Gumbel noise for the RANSAC draws
    (tests pass the JAX package's exact draws).
    """
    device = resolve_device(device)
    R_b2c = torch.as_tensor(np.asarray(R_b2c)).to(device=device, dtype=dtype)

    def scan(tracker_state: TrackerState, staged: StagedInputs,
             ransac_gumbel=None):
        ts = tracker_state
        outs = []
        for k in range(staged.images.shape[0]):
            ts, frame, _ = _track(tc, ts, staged, k, R_b2c, dtype,
                                  None if ransac_gumbel is None
                                  else ransac_gumbel[k])
            outs.append(frame)
        return ts, FrameInput(*(torch.stack(x) for x in zip(*outs)))

    return scan


def load_bench_images(image_paths, height, width, limit=None) -> np.ndarray:
    """(K, height, width) uint8 frames decoded from PNG paths."""
    from ..dataio._png import read_gray8

    paths = image_paths if limit is None else image_paths[:limit]
    out = np.empty((len(paths), height, width), np.uint8)
    for i, p in enumerate(paths):
        out[i] = read_gray8(p)
    return out
