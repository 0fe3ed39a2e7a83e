"""Carry state from the JAX package into the port.

The tracker has no weights; its state is the previous frame's prepared
pyramid and the track table. ``tracker_state_from_numpy`` takes that state
as numpy arrays (the JAX ``TrackerState`` read out field by field) and
returns the port's ``TrackerState``, so both packages can run onward from
the same mid-sequence state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .frontend.klt import MARGIN
from .frontend.tracker import TrackerConfig, TrackerState, level_shapes
from .ops.dma_gather import BL, BR
from .ops.window_gather import AlignedImage


def tracker_state_from_numpy(d: dict, tc: TrackerConfig, dtype=torch.float32,
                             device=None, seed: int = 0) -> TrackerState:
    """d: {"pyr": [(1, Hp, Wp) padded level images], "xy", "uvn",
    "desc" (uint32 (N, 8)), "fid", "t", "next_id"} as numpy arrays.

    The RANSAC generator starts from `seed`: the JAX key stream cannot be
    carried into torch."""
    device = resolve_device(device)

    def put(x, dt):
        x = np.require(x, requirements="W")  # torch wants writable arrays
        return torch.as_tensor(x).to(device=device, dtype=dt)

    pyr = []
    for padded, shape in zip(d["pyr"], level_shapes(tc)):
        p = put(padded, dtype)
        if p.dim() != 3 or p.shape[1] % BR or p.shape[2] % BL:
            raise ValueError(f"pyramid level {tuple(p.shape)} is not a "
                             "(C, Hp, Wp) tile-aligned padded image")
        pyr.append(AlignedImage(p, p.shape[1] // BR, p.shape[2] // BL,
                                MARGIN, shape))
    return TrackerState(
        pyr=tuple(pyr),
        xy=put(d["xy"], dtype),
        uvn=put(d["uvn"], dtype),
        desc=put(np.asarray(d["desc"], np.uint32).astype(np.int64),
                 torch.int64),
        fid=put(d["fid"], torch.int32),
        t=put(d["t"], dtype),
        next_id=put(d["next_id"], torch.int32),
        rng=torch.Generator(device=device).manual_seed(seed),
    )
