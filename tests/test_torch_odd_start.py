"""A stream that starts on an odd frame: both packages, tracker and
filter together as make_e2e_replay runs them.

tests/test_torch_batched.py's CPU stream (tests/test_torch_e2e.py's,
120x160, float64) starts on frame START = 1, 2 or 3: the frame index keeps
its place in the stream, so it sets the tracker's detection cadence
(detect_every = 2) as it does in the JAX package's scan. The JAX side runs
the replay's step (process_frame, then vio_step) under jax.jit frame by
frame from that index; the port runs make_e2e_replay(frames=range(START,
T)) with the JAX package's RANSAC draws and KLT_EPS = 0. Both agree on
whether and on which frame static init ends, and on every pose within
1e-6 m: an odd start never initializes statically in either package, an
even one does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.eval import staged as jstaged
from orcvio_tpu.filter.pipeline import FrameInput as JaxFrameInput
from orcvio_tpu.filter.pipeline import build_chi2_table as jax_chi2
from orcvio_tpu.frontend.tracker import TrackerConfig as JaxTrackerConfig
from orcvio_tpu.frontend.tracker import TrackerState as JaxTrackerState
from orcvio_tpu.frontend.tracker import process_frame as jax_process_frame
from orcvio_tpu.vio import VioState as JaxVioState
from orcvio_tpu.vio import vio_step as jax_vio_step
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.dataio import euroc_writer as pwriter
from orcvio_tpu_torch.dataio import synthetic as psyn
from orcvio_tpu_torch.eval.staged import make_e2e_replay, stage_sequence
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
from orcvio_tpu_torch.vio import VioState
from tests.test_torch_e2e import (FILTER, N, P_TOL, SIM, TRACKER, WC,
                                  _gumbels, init_frame)

torch.set_num_threads(1)

T = 30
STARTS = (1, 2, 3)
R_B2C, T_C_B = pwriter.R_B2C_DOWN, np.asarray(WC.t_c_b)


@pytest.fixture(scope="module")
def inputs():
    import chip_smoke as cs

    sim = psyn.SimConfig(n_frames=T, **SIM)
    return cs.bench_inputs(pwriter.make_stream(sim, WC, device="cpu"))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's replay step (eval/staged.py:make_e2e_replay),
    with the frame index an argument."""
    jtc, jcfg = JaxTrackerConfig(**TRACKER), JaxFilterConfig(**FILTER)
    chi2 = jax_chi2(jcfg, jnp.float64)
    R_b2c = jnp.asarray(R_B2C)

    def step(ts, vs, img_u8, t, it, ig, ia, im, idx):
        denom = jnp.maximum(jnp.sum(im), 1)
        mean_gyro = jnp.sum(jnp.where(im[:, None], ig, 0.0), axis=0) / denom
        ts, tout = jax_process_frame(jtc, ts, img_u8.astype(jnp.float64), t,
                                     mean_gyro, R_b2c, frame_idx=idx)
        frame = JaxFrameInput(t=t, imu_t=it, imu_gyro=ig, imu_acc=ia,
                              imu_mask=im, fids=tout.fids, uvs=tout.uvs,
                              uv_vels=tout.uv_vels, meas_mask=tout.meas_mask)
        vs, fout = jax_vio_step(jcfg, vs, frame, chi2)
        return ts, vs, fout.p, fout.R

    return jax.jit(step)


def jax_run(step, inputs, start):
    jtc, jcfg = JaxTrackerConfig(**TRACKER), JaxFilterConfig(**FILTER)
    staged = jstaged.stage_sequence(*inputs, jnp.float64)
    ts = JaxTrackerState.create(jtc, jnp.float64)
    vs = JaxVioState.create(jcfg, N, jnp.float64)
    vs = vs.replace(filter=vs.filter.replace(R_b2c=jnp.asarray(R_B2C),
                                             t_c_b=jnp.asarray(T_C_B)))
    ps, Rs = [], []
    for k in range(start, T):
        ts, vs, p, R = step(ts, vs, staged.images[k], staged.frame_ts[k],
                            staged.imu_t[k], staged.imu_gyro[k],
                            staged.imu_acc[k], staged.imu_mask[k],
                            jnp.asarray(k, jnp.int32))
        ps.append(np.asarray(p))
        Rs.append(np.asarray(R))
    return np.stack(ps), np.stack(Rs)


def port_run(inputs, start):
    """The port from a fresh state on frames [start, T), frame k drawing
    the JAX tracker's (k - start)-th RANSAC noise."""
    jts0 = JaxTrackerState.create(JaxTrackerConfig(**TRACKER), jnp.float64)
    g = _gumbels(jts0.rng, T - start)
    gumbel = torch.cat([g[:1].expand(start, *g.shape[1:]), g])
    mp = pytest.MonkeyPatch()
    mp.setattr(pklt, "KLT_EPS", 0.0)
    try:
        tc, cfg = TrackerConfig(**TRACKER), FilterConfig(**FILTER)
        replay = make_e2e_replay(cfg, tc, R_B2C, T_C_B, torch.float64,
                                 device="cpu")
        _, outs = replay(TrackerState.create(tc, torch.float64, device="cpu"),
                         VioState.create(cfg, N, torch.float64, device="cpu"),
                         stage_sequence(*inputs, torch.float64, device="cpu"),
                         ransac_gumbel=gumbel, frames=range(start, T))
    finally:
        mp.undo()
    return outs["p"].numpy(), outs["R"].numpy()


@pytest.mark.parametrize("start", STARTS)
def test_static_init_agrees_on_an_odd_or_even_start(inputs, jax_step, start):
    jp, jR = jax_run(jax_step, inputs, start)
    pp, pR = port_run(inputs, start)
    k0 = init_frame(jR)
    assert init_frame(pR) == k0
    if start % 2:
        assert k0 is None  # never initializes statically
    else:
        assert k0 is not None
    assert np.abs(pp - jp).max() < P_TOL
