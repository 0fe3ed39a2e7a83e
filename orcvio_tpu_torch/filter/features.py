"""Feature-table bookkeeping: matching, allocation, lifecycle.

Counterpart of ``orcvio_tpu/filter/features.py`` (reference:
addFeatureObservations, orcvio.cpp:1016): id matching and row allocation
are dense batched ops over the fixed-capacity table (an M x F match and a
prefix-sum slot assignment); writes go through a spill row.
"""
from __future__ import annotations

import torch

from .state import FeatureTable, set_rows


def add_observations(table: FeatureTable, slot, fids, uvs, uv_vels, meas_valid):
    """Scatter this frame's measurements into the table at clone `slot`
    (0-d tensor). Matching rows get the new observation; unmatched
    measurements take free rows in table order; rows that get no
    measurement become inactive. Returns (table, tracked_count)."""
    F = table.fid.shape[0]
    M = fids.shape[0]
    dev = fids.device
    meas_valid = meas_valid & (fids >= 0)

    live = table.fid >= 0
    eq = (fids[:, None] == table.fid[None, :]) & meas_valid[:, None] & live[None, :]
    matched_meas = torch.any(eq, dim=1)
    row_of_meas = torch.argmax(eq.to(torch.int8), dim=1)

    is_new = meas_valid & ~matched_meas
    free = ~live
    free_rank = torch.cumsum(free, 0) - 1
    new_rank = torch.cumsum(is_new, 0) - 1
    n_free = torch.sum(free)
    can_alloc = is_new & (new_rank < n_free)
    ar = torch.arange(F, device=dev)
    rank_to_row = set_rows(torch.zeros(F, dtype=torch.long, device=dev),
                           torch.where(free, free_rank, F), ar)
    alloc_row = rank_to_row[torch.clamp(new_rank, 0, F - 1)]

    target_row = torch.where(matched_meas, row_of_meas, alloc_row)
    write = matched_meas | can_alloc
    rows = torch.where(write, target_row, F)
    cols = slot.long().reshape(1).expand(M)
    true = torch.ones((), dtype=torch.bool, device=dev)
    uv = set_rows(table.uv, rows, uvs, cols)
    uv_vel = set_rows(table.uv_vel, rows, uv_vels, cols)
    uv_valid = set_rows(table.uv_valid, rows, true, cols)
    fid = set_rows(table.fid, torch.where(can_alloc, target_row, F), fids)

    got_meas = set_rows(torch.zeros(F, dtype=torch.bool, device=dev), rows, true)
    active = got_meas & (fid >= 0)
    tracked_count = torch.sum(matched_meas)
    return table.replace(uv=uv, uv_vel=uv_vel, uv_valid=uv_valid, fid=fid,
                         active=active), tracked_count


def track_lengths(table: FeatureTable):
    return torch.sum(table.uv_valid, dim=1)


def free_rows(table: FeatureTable, kill_mask):
    """Erase features (map_server.erase): clear obs, id and state."""
    keep = ~kill_mask
    return table.replace(
        uv_valid=table.uv_valid & keep[:, None],
        fid=torch.where(kill_mask, -1, table.fid),
        active=table.active & keep,
        in_state=table.in_state & keep,
        state_slot=torch.where(kill_mask, -1, table.state_slot),
        anchor_slot=torch.where(kill_mask, -1, table.anchor_slot),
    )
