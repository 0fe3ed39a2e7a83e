"""Feature-parallel measurement update: the feature table cut into shards,
the shards' information pairs summed.

Counterpart of ``orcvio_tpu/parallel/feature_parallel.py``. The stacked
MSCKF update depends on the measurements only through the information
pair Lambda = H^T H, b = H^T r (isotropic noise), a sum over features. So
each shard of the feature table gives its own pair and the pairs add:
the JAX package's ``psum`` over its ``fp`` mesh axis. Here the shards are
a leading batch axis that ``feature_jacobians`` runs over at once
(``torch.func.vmap``); over a list of devices each device takes a
contiguous chunk of shards and the partial sums meet on the first; across
processes (``parallel/multihost.py``) each process takes its own chunk
and the pair goes through ``torch.distributed.all_reduce``. The state
stays replicated: every process ends with the same state. The update is
``filter/update.py:information_update``; no kernel runs on this path.
"""
from __future__ import annotations

import torch

from .. import no_tf32
from ..config.core import FilterConfig
from ..filter.tracks import CompactTracks
from ..filter.update import (FeatureJacobians, feature_jacobians,
                             information_update)
from ..tree import tree_map
from .multihost import all_reduce_sum, process_chunk, world_size
from .replay import shard_batch


def information_from_jacobians(fj: FeatureJacobians, use_mask):
    """(Lambda, b) summed over these features' rows (unused rows zero)."""
    H = torch.where(use_mask[:, None, None], fj.H, 0.0)
    r = torch.where(use_mask[:, None], fj.r, 0.0)
    Hm = H.reshape(-1, H.shape[-1])
    rm = r.reshape(-1)
    return Hm.T @ Hm, Hm.T @ rm


def pad_feature_axis(ct: CompactTracks, p_w, use, n_shards: int):
    """ct, p_w and use padded on the feature axis to a multiple of
    n_shards (capacity 21 over 8 shards, say). The padded rows are zeros
    with use False, so they add exact zeros to the information pair."""
    F = use.shape[0]
    pad = (-F) % n_shards
    if pad == 0:
        return ct, p_w, use

    def grow(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype,
                                         device=x.device)])

    return tree_map(grow, ct), grow(p_w), grow(use)


def feature_parallel_update(cfg: FilterConfig, mesh=None, n_shards=None):
    """fn(state, ct, p_w, use) -> (state, dx): the information-form update
    with the feature axis cut into shards.

    ct: CompactTracks (F, ...), p_w (F, 3) triangulated positions, use
    (F,) the features that enter the update. The feature axis is padded to
    a multiple of the shard count and cut into n_shards contiguous shards
    (default: one a device of `mesh` in every process). With `mesh` (a
    list of devices) each device takes a contiguous chunk of this
    process's shards; where torch.distributed is initialized, each
    process takes its own chunk of all the shards and the pair is summed
    across processes. The update runs on the state's device."""

    def fn(state, ct, p_w, use):
        no_tf32()
        devices = mesh or [state.P.device]
        n = n_shards or len(devices) * world_size()
        ct, p_w, use = pad_feature_axis(ct, p_w, use, n)
        shards = tree_map(lambda x: x.reshape(n, -1, *x.shape[1:]),
                          (ct, p_w, use))
        mine = process_chunk(shards)
        D = state.P.shape[0]
        Lam = torch.zeros((D, D), dtype=state.P.dtype, device=state.P.device)
        b = torch.zeros(D, dtype=state.P.dtype, device=state.P.device)
        # shard_batch gives the devices that get no shard no chunk: those
        # are the last ones, so the zip pairs each chunk with its device
        for dev, (c, pw, u) in zip(devices, shard_batch(mine, devices)):
            st = tree_map(lambda x: x.to(dev), state)

            def one(c1, pw1, u1):
                fj = feature_jacobians(cfg, st, c1, pw1)
                return information_from_jacobians(fj, u1)

            Ls, bs = torch.func.vmap(one)(c, pw, u)
            Lam = Lam + Ls.sum(0).to(state.P.device)
            b = b + bs.sum(0).to(state.P.device)
        Lam, b = all_reduce_sum(Lam), all_reduce_sum(b)
        return information_update(cfg, state, Lam, b)

    return fn
