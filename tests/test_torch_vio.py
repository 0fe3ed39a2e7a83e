"""vio_step, static init then the filter: the port against the JAX package.

The fixture is ``orcvio_tpu.dataio.synthetic.generate`` with a 1 s static
start (20 frames), then motion, at small capacities and the bench flags;
static init needs 5 static frames (as ``test_replay_path.py`` sets it).
Both packages start uninitialized and run 16 frames in float64 on the CPU.
Init falls on the same frame with the same R, v and biases (1e-12), and
every frame's p, R and v agree within 1e-8. ``convert.vio_state_from_numpy``
carries the JAX state into the port mid-sequence, once during the static
phase and once after init, and the port runs on to the same results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.dataio.synthetic import SimConfig, generate
from orcvio_tpu.filter.pipeline import build_chi2_table as jax_chi2
from orcvio_tpu.vio import VioState as JaxVioState
from orcvio_tpu.vio import vio_step as jax_vio_step
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import state_to_numpy, vio_state_from_numpy
from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
from orcvio_tpu_torch.vio import VioState, vio_step

torch.set_num_threads(1)

T = 16
TOL = 1e-8
CFG = dict(sw_size=8, max_features=48, max_track_len=6, imu_slab=24,
           max_update_features=8, use_larvio=True, use_left_perturbation=False,
           use_closed_form_cov_prop=True, if_zupt=True, feature_idp_dim=1,
           ekf_feature_cap=6, observation_noise=0.004,
           tri_translation_threshold=-1.0, zupt_max_feature_dis=0.012,
           static_image_num=5, static_min_matches=10)
SIM = SimConfig(n_frames=T, n_landmarks=120, max_obs=40, imu_slab=24, seed=3,
                uv_noise=0.001, static_time=1.0, ramp_time=1.0, fov_limit=0.9)
R_B2C = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_C_B = np.asarray([0.05, 0.02, 0.0])


def port_frame(frames, k):
    return FrameInput(*(torch.as_tensor(np.array(x[k])) for x in frames))


def pose(fs):
    return {f: np.asarray(getattr(fs.imu, f)) for f in ("R", "v", "p", "bg", "ba")}


def run_port(state, frames, start):
    cfg = FilterConfig(**CFG)
    chi2 = build_chi2_table(cfg, torch.float64, device="cpu")
    out = []
    for k in range(start, T):
        state, _ = vio_step(cfg, state, port_frame(frames, k), chi2)
        out.append((bool(state.filter.initialized), pose(state.filter)))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Per frame (initialized, pose) and the JAX states after each frame."""
    data = generate(SIM, R_b2c=R_B2C, t_c_b=T_C_B)
    frames = jax.tree.map(np.asarray, data.frames)
    cfg = JaxConfig(**CFG)
    chi2 = jax_chi2(cfg, jnp.float64)
    st = JaxVioState.create(cfg, SIM.max_obs, jnp.float64)
    st = st.replace(filter=st.filter.replace(R_b2c=jnp.asarray(R_B2C),
                                             t_c_b=jnp.asarray(T_C_B)))
    step = jax.jit(jax_vio_step, static_argnums=0)
    out, states = [], []
    for k in range(T):
        st, _ = step(cfg, st, jax.tree.map(lambda x: jnp.asarray(x[k]), frames),
                     chi2)
        out.append((bool(st.filter.initialized), pose(st.filter)))
        states.append(st)
    return frames, out, states


def first_init(run):
    return next(k for k, (init, _) in enumerate(run) if init)


def assert_runs_match(ours, theirs):
    assert [i for i, _ in ours] == [i for i, _ in theirs]
    for k, ((_, a), (_, b)) in enumerate(zip(ours, theirs)):
        for f in ("p", "R", "v"):
            err = np.abs(a[f] - b[f]).max()
            assert err < TOL, (k, f, err)


def test_init_on_the_same_frame_with_the_same_state(jax_run):
    frames, theirs, _ = jax_run
    st = VioState.create(FilterConfig(**CFG), SIM.max_obs, torch.float64,
                         device="cpu")
    st = st.replace(filter=st.filter.replace(R_b2c=torch.as_tensor(R_B2C),
                                             t_c_b=torch.as_tensor(T_C_B)))
    ours = run_port(st, frames, 0)
    k0 = first_init(theirs)
    assert 5 <= k0 < T - 5, k0
    assert first_init(ours) == k0
    for f in ("R", "v", "bg", "ba"):
        np.testing.assert_allclose(ours[k0][1][f], theirs[k0][1][f], rtol=0,
                                   atol=1e-12, err_msg=f)
    assert np.abs(theirs[k0][1]["bg"]).max() > 0  # the gyro bias is estimated
    assert_runs_match(ours, theirs)


@pytest.mark.parametrize("when", ["static", "initialized"])
def test_vio_state_from_numpy_carries_on(jax_run, when):
    """Start the port from the JAX state after frame k and run on."""
    frames, theirs, states = jax_run
    k = 2 if when == "static" else first_init(theirs) + 2
    st = vio_state_from_numpy(state_to_numpy(states[k]), torch.float64,
                              device="cpu")
    assert st.host_initialized == (when == "initialized")
    assert st.sinit.counter.dtype == torch.int32
    assert st.filter.P.dtype == torch.float64
    assert_runs_match(run_port(st, frames, k + 1), theirs[k + 1:])
