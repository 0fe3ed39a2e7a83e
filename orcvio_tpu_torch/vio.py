"""Top-level VIO step: static initialization -> filter.

Counterpart of ``orcvio_tpu/vio.py`` (reference: processFeatures entry,
orcvio.cpp:500-560). The JAX package selects the branch with ``lax.cond``
on the device flag ``initialized``. Here the flag is read on the host only
while it is false, which is the static phase: one read a frame until
initialization, then ``host_initialized`` is set and every later frame runs
``filter_step`` alone, with no read at all (``initialized`` never returns
to false). So the frame loop after initialization never waits for the card.
``batched_vio_step`` runs B streams through ``torch.func.vmap`` of the same
step, the counterpart of ``jax.vmap`` over it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .config.core import FilterConfig
from .filter.pipeline import FrameInput, FrameOutput, filter_step
from .filter.state import FilterState
from .tree import Tree, tree_where
from .init.static_init import StaticInitState, initial_imu_state, static_init_step


@dataclasses.dataclass
class VioState(Tree):
    _static = ("host_initialized",)

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
                      zupt=torch.zeros_like(fs.initialized),
                      n_ekf_features=torch.zeros_like(st.sinit.counter))
    return st.replace(filter=fs, sinit=sinit), out


def vio_step(cfg: FilterConfig, state: VioState, frame: FrameInput, chi2_table):
    """One frame end to end (init or filter)."""
    if not state.host_initialized and bool(state.filter.initialized):
        state = state.replace(host_initialized=True)
    if not state.host_initialized:
        return _init_step(cfg, state, frame)
    return _filter_step(cfg, state, frame, chi2_table)


def _filter_step(cfg: FilterConfig, st: VioState, frame: FrameInput,
                 chi2_table):
    fs, out = filter_step(cfg, st.filter, frame, chi2_table)
    return st.replace(filter=fs), out


def batched_vio_step(cfg: FilterConfig, states: VioState, frames: FrameInput,
                     chi2_table):
    """vio_step for B streams at once, one flag per stream: states and
    frames are stacked (leaves (B, ...)) and the step is torch.func.vmap of
    the single-stream one. While a stream is not initialized the (B,) flag
    is read on the host once a frame: all false runs the init step, all
    true the filter step (and from then on nothing is read), a mix runs
    both and takes each row's own, which is what jax.vmap makes of the
    JAX package's lax.cond."""
    if not states.host_initialized:
        flags = states.filter.initialized.tolist()
        if all(flags):
            states = states.replace(host_initialized=True)
        elif not any(flags):
            return torch.func.vmap(functools.partial(_init_step, cfg))(
                states, frames)
        else:
            def both(st, frame):
                return tree_where(st.filter.initialized,
                                  _filter_step(cfg, st, frame, chi2_table),
                                  _init_step(cfg, st, frame))

            return torch.func.vmap(both)(states, frames)
    return torch.func.vmap(functools.partial(
        _filter_step, cfg, chi2_table=chi2_table))(states, frames)


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
