"""Track compaction: each feature's valid observations in a dense,
time-sorted prefix of length max_track_len.

Counterpart of ``orcvio_tpu/filter/tracks.py``: per-feature math then runs
on (F, T <= 6) tensors instead of (F, SW = 20).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .state import FeatureTable

_INT_MAX = torch.iinfo(torch.int32).max


class CompactTracks(NamedTuple):
    uv: torch.Tensor  # (F, T, 2)
    uv_vel: torch.Tensor  # (F, T, 2)
    slot: torch.Tensor  # (F, T) int64 clone slot of each observation
    mask: torch.Tensor  # (F, T) bool, valid prefix sorted by clone order
    n_obs: torch.Tensor  # (F,) int32

    def take(self, idx):
        """The rows idx of every field."""
        return CompactTracks(*(x[idx] for x in self))


def compact_tracks(table: FeatureTable, clone_order, T: int) -> CompactTracks:
    """Sort each row's observations by clone insertion order (stable, as
    JAX's argsort), keep the first T. Entry n_obs-1 is the newest."""
    key = torch.where(table.uv_valid, clone_order[None, :], _INT_MAX)
    perm = torch.sort(key, dim=1, stable=True).indices[:, :T]
    mask = torch.take_along_dim(table.uv_valid, perm, dim=1)
    uv = torch.take_along_dim(table.uv, perm[..., None], dim=1)
    uv_vel = torch.take_along_dim(table.uv_vel, perm[..., None], dim=1)
    return CompactTracks(uv=uv, uv_vel=uv_vel, slot=perm, mask=mask,
                         n_obs=torch.sum(mask, dim=1).to(torch.int32))
