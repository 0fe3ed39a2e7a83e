"""The per-frame filter step: propagate -> augment -> ingest -> ZUPT ->
update -> prune.

Counterpart of ``orcvio_tpu/filter/pipeline.py`` (reference:
OrcVIO::processFeatures, orcvio.cpp:500): FilterState x FrameInput ->
FilterState x FrameOutput, at fixed capacities and with masks, as the JAX
package runs it, for every flag of ``config.core.FilterConfig``.
Nothing in a step reads the device back: choices are made with
``torch.where`` over whole states, scatters go through spill rows, and
the ranks use a stable sort (``math.linalg.top_k_indices``).

Kernel K4 (``ops/cov_update.py``) runs three times a frame, in the
stacked update, the ZUPT update (computed every frame and kept where ZUPT
fires) and the last-chance update, except under the "information" update
form and the Joseph form without Schmidt states, whose covariance steps
are plain algebra.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig
from ..math import linalg
from . import features as feat
from . import propagation as prop
from .augment import (cam_poses, current_clone_slot, prune_clones,
                      select_prune_slots, state_augmentation)
from .hybrid import (_idp_jacobian, ekf_feature_rows, promote_features,
                     reanchor_features, remove_state_features,
                     retire_nuisance, schmidt_demote, split_projection)
from ..tree import tree_where
from .state import FilterState, set_rows
from .tracks import compact_tracks
from .triangulation import check_motion, triangulate
from .update import apply_ekf_update, feature_jacobians, gate_features, msckf_update
from .zupt import check_zupt_feat, check_zupt_imu, zupt_update
from ..utils.profiling import span


class FrameInput(NamedTuple):
    """One camera frame + its IMU slab (pre-binned at dataset load)."""

    t: torch.Tensor  # scalar image timestamp
    imu_t: torch.Tensor  # (S,)
    imu_gyro: torch.Tensor  # (S, 3)
    imu_acc: torch.Tensor  # (S, 3)
    imu_mask: torch.Tensor  # (S,)
    fids: torch.Tensor  # (M,) int32 feature track ids
    uvs: torch.Tensor  # (M, 2) normalized coords
    uv_vels: torch.Tensor  # (M, 2)
    meas_mask: torch.Tensor  # (M,)


class FrameOutput(NamedTuple):
    t: torch.Tensor
    R: torch.Tensor  # (3, 3) body->world
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    n_update_features: torch.Tensor
    dx_norm: torch.Tensor
    zupt: torch.Tensor  # ZUPT fired this frame
    n_ekf_features: torch.Tensor  # in-state (EKF) features after the frame


def build_chi2_table(cfg: FilterConfig, dtype=torch.float32, device=None):
    """The chi-square gate's table, on `device` (the card unless given)."""
    return torch.as_tensor(linalg.chi_squared_table(cfg.chi2_confidence),
                           dtype=dtype).to(resolve_device(device))


def filter_step(cfg: FilterConfig, state: FilterState, frame: FrameInput,
                chi2_table):
    """One frame. Ref call stack: orcvio.cpp:500-660 (processFeatures).

    Float32 products stay in full float32 (no TF32): the covariance algebra
    is as sensitive to TF32 as the JAX package's is to bf16 passes.

    The stages run inside spans (``utils/profiling.py:span``): propagate,
    augment, ingest, zupt, classify, triangulate, jacobians, update,
    select, last_chance and prune, each entered once, whatever the flags;
    every statement lies in one of them. The last-chance stage holds its
    own triangulate, jacobians and update."""
    with span("filter.propagate"):
        no_tf32()
        dtype = state.P.dtype
        sw = cfg.sw_size
        # 1. IMU propagation to the frame time (batchImuProcessing, :567)
        state = prop.imu_batch(cfg, state, frame.imu_t, frame.imu_gyro,
                               frame.imu_acc, frame.imu_mask)
    with span("filter.augment"):
        # 2. clone augmentation (:930)
        state = state_augmentation(cfg, state)
        cur_slot = current_clone_slot(state)

    with span("filter.ingest"):
        # 3. ingest feature measurements (addFeatureObservations, :1016)
        prev_live = torch.sum(state.features.active)
        if cfg.prediction_only:
            tracking_rate = torch.ones((), dtype=dtype, device=state.P.device)
        else:
            table, tracked = feat.add_observations(
                state.features, cur_slot, frame.fids, frame.uvs,
                frame.uv_vels, frame.meas_mask)
            state = state.replace(features=table)
            tracking_rate = tracked / torch.clamp(prev_live, min=1)

    with span("filter.zupt"):
        # 3b. zero-velocity update (orcvio.cpp:580-590)
        do_zupt = torch.zeros((), dtype=torch.bool, device=state.P.device)
        if cfg.if_zupt:
            do_zupt = check_zupt_feat(cfg, state) | check_zupt_imu(
                cfg, state, frame.imu_t, frame.imu_gyro, frame.imu_acc,
                frame.imu_mask, chi2_table)
            state = tree_where(do_zupt, zupt_update(cfg, state), state)

    with span("filter.classify"):
        # 4. classification (removeLostFeatures, :2196): drop in-state
        #    features that lost track or whose anchor died
        #    (rmLostFeaturesCov, :3776) (an anchor demoted to a nuisance
        #    slot lives while the slot does)
        E = cfg.ekf_feature_cap
        schmidt = cfg.use_schmidt and cfg.nuisance_cap > 0
        if E:
            ft = state.features
            valid_ext = state.clones.valid
            if cfg.nuisance_cap:
                valid_ext = torch.cat([valid_ext, state.nui.valid])
            anchor_ok = (ft.anchor_slot >= 0) & valid_ext[
                torch.clamp(ft.anchor_slot.long(), 0, valid_ext.shape[0] - 1)]
            kill_state = ft.in_state & (~ft.active | ~anchor_ok)
            state = remove_state_features(cfg, state, kill_state)
            state = state.replace(features=feat.free_rows(state.features,
                                                          kill_state))
            if schmidt:
                state = retire_nuisance(cfg, state)

    with span("filter.triangulate"):
        ft = state.features
        live = ft.fid >= 0
        active = ft.active
        in_state = ft.in_state
        tl = feat.track_lengths(ft)
        lost = live & ~active & ~in_state
        too_long = live & active & (tl >= cfg.max_track_len) & ~in_state
        finished = lost | too_long
        enough = tl >= cfg.min_track_len

        # 5. triangulation on the top-K finishing candidates, without the
        #    current clone's observation (feature.hpp:416)
        ct = compact_tracks(ft, state.clones.order, cfg.max_track_len)
        tri_mask = ct.mask & ~(active[:, None] & (ct.slot == cur_slot))
        ct_tri = ct._replace(mask=tri_mask,
                             n_obs=torch.sum(tri_mask, dim=1).to(torch.int32))
        R_c2w, t_c_w = cam_poses(state)
        motion_ok = check_motion(ct_tri, R_c2w, t_c_w,
                                 cfg.tri_translation_threshold)

        F = ft.fid.shape[0]
        Kc = min(cfg.max_update_features, F)
        pre_cand = finished & enough & motion_ok
        cand_idx = linalg.top_k_indices(pre_cand.to(dtype), Kc)
        tri = triangulate(cfg, ct_tri.take(cand_idx), R_c2w, t_c_w)

    with span("filter.jacobians"):
        # 6. Jacobians over the full track, gate
        fj = feature_jacobians(cfg, state, ct.take(cand_idx), tri.p_world)
        gated = gate_features(cfg, state, fj, chi2_table)
        use_k = pre_cand[cand_idx] & tri.valid & fj.usable & gated
        too_long_k = too_long[cand_idx]
        spill = torch.zeros(F, dtype=torch.bool, device=state.P.device)
        true = torch.ones((), dtype=torch.bool, device=state.P.device)

    with span("filter.update"):
        if E:
            # promotions: tracked-too-long, valid triangulation, free slots
            cand_k = use_k & too_long_k
            n_free = E - torch.sum(in_state)
            rank = torch.cumsum(cand_k, 0) - 1
            promote_k = cand_k & (rank < torch.clamp(n_free, max=4))

            # idp feature Jacobian at the pre-update linearization
            # (featureJacobian_ekf_new, orcvio.cpp:1481); 1-d: the rho column
            inv_k = tri.inv_param
            a = torch.clamp(tri.anchor_slot.long(), 0, sw - 1)
            dpw_didp = R_c2w[a] @ _idp_jacobian(inv_k)
            Hf_idp = torch.einsum("fmi,fij->fmj", fj.Hf_raw, dpw_didp)
            if cfg.feature_idp_dim == 1:
                Hf_idp = Hf_idp[..., 2:3]

            # stacked update: msckf rows + tracked in-state feature rows;
            # promoted features give their feature-free rows (orcvio.cpp:1766)
            D = state.P.shape[0]
            M = fj.H.shape[1]
            _, _, _, Ho_k, ro_k = split_projection(Hf_idp, fj.H_raw, fj.r_raw)
            Hm_rows = torch.where(promote_k[:, None, None], Ho_k, fj.H)
            rm_rows = torch.where(promote_k[:, None], ro_k, fj.r)
            Hm = torch.where(use_k[:, None, None], Hm_rows, 0.0).reshape(
                Kc * M, D)
            rm = torch.where(use_k[:, None], rm_rows, 0.0).reshape(Kc * M)
            er = ekf_feature_rows(cfg, state, cur_slot)
            etop = linalg.top_k_indices(er.valid.to(dtype), min(E, F))
            ev = er.valid[etop]
            He = torch.where(ev[:, None, None], er.H[etop], 0.0).reshape(-1, D)
            re = torch.where(ev[:, None], er.r[etop], 0.0).reshape(-1)
            state, dx = apply_ekf_update(cfg, state, torch.cat([Hm, He]),
                                         torch.cat([rm, re]))

            # new feature blocks from the post-update P and dx
            prow = torch.where(promote_k, cand_idx, F)
            promote_mask = set_rows(spill, prow, true)
            ftab = state.features
            state = state.replace(features=ftab.replace(
                idp=set_rows(ftab.idp, prow, inv_k),
                anchor_slot=set_rows(ftab.anchor_slot, prow,
                                     tri.anchor_slot.to(torch.int32))))
            state = promote_features(cfg, state, promote_k, fj.H_raw, Hf_idp,
                                     fj.r_raw, dx, row_ids=cand_idx)
            erase = finished & ~promote_mask
            use = set_rows(spill, torch.where(use_k & ~promote_k, cand_idx, F),
                           true)
        else:
            state, dx = msckf_update(cfg, state, fj, use_k)
            use = set_rows(spill, torch.where(use_k, cand_idx, F), true)
            erase = finished

    with span("filter.select"):
        # 7. cleanup: erase finished features (map_server.erase, :2570-2576)
        state = state.replace(features=feat.free_rows(state.features, erase))

        # 8. prune clones when the window is full (pruneImuStateBuffer, :2629)
        prune_mask, _ = select_prune_slots(cfg, state, tracking_rate)

    with span("filter.last_chance"):
        # 8a. last-chance update on the observations dying with the pruned
        #     clones (orcvio.cpp:2803-2851), position from the full track;
        #     skipped when a ZUPT fired this frame
        if cfg.prune_last_chance and not cfg.prediction_only:
            with span("filter.triangulate"):
                ft = state.features
                order = state.clones.order
                ct_lc = compact_tracks(
                    ft.replace(uv_valid=ft.uv_valid & prune_mask[None, :]),
                    order, cfg.max_track_len)
                cand_lc = (ft.fid >= 0) & ~ft.in_state & (ct_lc.n_obs >= 2)
                ct_all = compact_tracks(ft, order, cfg.max_track_len)
                R_c2w2, t_c_w2 = cam_poses(state)
                lc_idx = linalg.top_k_indices(cand_lc.to(dtype), Kc)
                ct_all_k = ct_all.take(lc_idx)
                motion_lc = check_motion(ct_all_k, R_c2w2, t_c_w2,
                                         cfg.tri_translation_threshold)
                tri_lc = triangulate(cfg, ct_all_k, R_c2w2, t_c_w2)
            with span("filter.jacobians"):
                fj_lc = feature_jacobians(cfg, state, ct_lc.take(lc_idx),
                                          tri_lc.p_world)
                gated_lc = gate_features(cfg, state, fj_lc, chi2_table)
                use_lc = (cand_lc[lc_idx] & motion_lc & tri_lc.valid
                          & fj_lc.usable & gated_lc & ~do_zupt
                          & torch.any(prune_mask))
            with span("filter.update"):
                state, _ = msckf_update(cfg, state, fj_lc, use_lc)

    with span("filter.prune"):
        if E:
            # Schmidt: pruned anchors move to nuisance slots first; those
            # that find no free slot fall through to re-anchoring and removal
            if schmidt:
                state = schmidt_demote(cfg, state, prune_mask)
            # re-anchor surviving features to the current clone
            # (orcvio.cpp:2666); degenerate ones fall through to removal
            state = reanchor_features(cfg, state, prune_mask, cur_slot)
            ft = state.features
            anchor_pruned = ft.in_state & (ft.anchor_slot < sw) & prune_mask[
                torch.clamp(ft.anchor_slot.long(), 0, sw - 1)]
            state = remove_state_features(cfg, state, anchor_pruned)
            state = state.replace(features=feat.free_rows(state.features,
                                                          anchor_pruned))
        state = prune_clones(state, prune_mask)

        out = FrameOutput(t=state.t, R=state.imu.R, p=state.imu.p,
                          v=state.imu.v,
                          n_update_features=torch.sum(use).to(torch.int32),
                          dx_norm=torch.linalg.norm(dx), zupt=do_zupt,
                          n_ekf_features=torch.sum(
                              state.features.in_state).to(torch.int32))
    return state, out


def run_sequence(cfg: FilterConfig, state: FilterState, frames: FrameInput,
                 chi2_table):
    """filter_step over stacked FrameInputs (leading time axis); returns
    (final state, FrameOutput of stacked tensors)."""
    outs = []
    for k in range(frames.t.shape[0]):
        state, out = filter_step(cfg, state, FrameInput(*(x[k] for x in frames)),
                                 chi2_table)
        outs.append(out)
    return state, FrameOutput(*(torch.stack(x) for x in zip(*outs)))
