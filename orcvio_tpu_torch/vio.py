"""Top-level VIO step: static initialization -> filter.

Counterpart of ``orcvio_tpu/vio.py`` (reference: processFeatures entry,
orcvio.cpp:500-560). The JAX package selects the branch with ``lax.cond``
on the device flag ``initialized``. Here the flag is read on the host only
while it is false, which is the static phase: one read a frame until
initialization, then ``host_initialized`` is set and every later frame runs
``filter_step`` alone, with no read at all (``initialized`` never returns
to false). So the frame loop after initialization never waits for the card.
"""
from __future__ import annotations

import dataclasses

import torch

from .config.core import FilterConfig
from .filter.pipeline import FrameInput, FrameOutput, filter_step
from .filter.state import FilterState, _Tree, tree_where
from .init.static_init import StaticInitState, initial_imu_state, static_init_step


@dataclasses.dataclass
class VioState(_Tree):
    filter: FilterState
    sinit: StaticInitState
    host_initialized: bool = False  # host copy of filter.initialized, once true

    @classmethod
    def create(cls, cfg: FilterConfig, max_obs: int, dtype=torch.float32,
               device=None):
        return cls(filter=FilterState.create(cfg, dtype, device),
                   sinit=StaticInitState.create(max_obs, dtype, device))


def _init_step(cfg: FilterConfig, st: VioState, frame: FrameInput):
    sinit = static_init_step(cfg, st.sinit, frame.fids, frame.uvs,
                             frame.meas_mask, frame.imu_gyro, frame.imu_acc,
                             frame.imu_mask)
    just_done = sinit.done & ~st.sinit.done
    fs = st.filter
    imu0 = initial_imu_state(cfg, sinit, fs.P.dtype)
    # the last valid IMU sample time is the state time at takeoff
    masked_t = torch.where(frame.imu_mask, frame.imu_t, -torch.inf)
    t0 = torch.max(masked_t)
    t0 = torch.where(torch.isfinite(t0), t0, frame.t).to(fs.t.dtype)
    last = torch.argmax(masked_t).reshape(1)
    fs_new = fs.replace(
        imu=imu0, imu_old=imu0, imu_fej_now=imu0, imu_fej_old=imu0, t=t0,
        initialized=torch.ones_like(fs.initialized),
        last_gyro=frame.imu_gyro.index_select(0, last)[0],
        last_acc=frame.imu_acc.index_select(0, last)[0])
    fs = tree_where(just_done, fs_new, fs)
    out = FrameOutput(t=frame.t, R=fs.imu.R, p=fs.imu.p, v=fs.imu.v,
                      n_update_features=torch.zeros_like(st.sinit.counter),
                      dx_norm=torch.zeros_like(fs.t),
                      zupt=torch.zeros_like(fs.initialized))
    return st.replace(filter=fs, sinit=sinit), out


def vio_step(cfg: FilterConfig, state: VioState, frame: FrameInput, chi2_table):
    """One frame end to end (init or filter)."""
    if not state.host_initialized and bool(state.filter.initialized):
        state = state.replace(host_initialized=True)
    if not state.host_initialized:
        return _init_step(cfg, state, frame)
    fs, out = filter_step(cfg, state.filter, frame, chi2_table)
    return state.replace(filter=fs), out


def run_vio(cfg: FilterConfig, state: VioState, frames: FrameInput,
            chi2_table):
    """vio_step over stacked frames (T, ...): (final state, FrameOutput of
    (T, ...) tensors), the JAX package's ``lax.scan`` as a loop."""
    outs = []
    for k in range(frames.t.shape[0]):
        state, out = vio_step(cfg, state, FrameInput(*(x[k] for x in frames)),
                              chi2_table)
        outs.append(out)
    return state, FrameOutput(*(torch.stack(x) for x in zip(*outs)))
