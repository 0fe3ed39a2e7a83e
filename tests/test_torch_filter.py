"""The filter as a whole: 100 frames of the port's filter_step against the
JAX package's, from one initialized state, in float64 on the CPU.

The fixture is ``orcvio_tpu.dataio.synthetic.generate`` (as
``__graft_entry__._build`` uses it) with a 1 s static start, then motion,
at small capacities (8 clones, 48 feature rows, 6 one-dof EKF features,
8 update features) and the bench flags (LARVIO, right perturbation, ZUPT,
1-d inverse depth, "direct" update). In it, stacked updates, promotions,
re-anchoring, ZUPT and last-chance updates all fire, in both packages.

Per frame: p, R and v within 1e-8 (float64; the packages sum in other
orders, and the gap grows to about 1e-9 over the run), identical update
counts and ZUPT flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.dataio.synthetic import SimConfig, generate, initial_state_np
from orcvio_tpu.filter import pipeline as jpipe
from orcvio_tpu.filter.state import FilterState as JaxState
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import pipeline as ppipe

torch.set_num_threads(1)

T = 100
TOL = 1e-8
CFG = dict(sw_size=8, max_features=48, max_track_len=6, imu_slab=24,
           max_update_features=8, use_larvio=True, use_left_perturbation=False,
           use_closed_form_cov_prop=True, if_zupt=True, feature_idp_dim=1,
           ekf_feature_cap=6, observation_noise=0.004,
           tri_translation_threshold=-1.0, zupt_max_feature_dis=0.012)
SIM = SimConfig(n_frames=T, n_landmarks=120, max_obs=40, imu_slab=24, seed=3,
                uv_noise=0.001, static_time=1.0, ramp_time=1.0, fov_limit=0.9)
R_B2C = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_C_B = np.asarray([0.05, 0.02, 0.0])


def sim_frames():
    """The fixture's frames as numpy, and its initialized JAX state."""
    data = generate(SIM, R_b2c=R_B2C, t_c_b=T_C_B)
    st = JaxState.create(JaxConfig(**CFG), jnp.float64)
    R0, p0, v0 = initial_state_np(SIM)
    imu = st.imu.replace(R=jnp.asarray(R0), p=jnp.asarray(p0),
                         v=jnp.asarray(v0))
    st = st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                    R_b2c=jnp.asarray(R_B2C), t_c_b=jnp.asarray(T_C_B),
                    initialized=jnp.ones((), bool))
    return jax.tree.map(np.asarray, data.frames), st


def port_frame(frames, k):
    return ppipe.FrameInput(*(torch.as_tensor(np.array(x[k])) for x in frames))


def events(in_state, anchor):
    """Promotions (rows entering the state) and re-anchorings (rows staying
    in the state with another anchor) between consecutive frames."""
    stay = in_state[1:] & in_state[:-1]
    return (int((in_state[1:] & ~in_state[:-1]).sum()),
            int((stay & (anchor[1:] != anchor[:-1])).sum()))


@pytest.fixture(scope="module")
def runs():
    frames, st0 = sim_frames()
    jcfg = JaxConfig(**CFG)
    chi2 = jpipe.build_chi2_table(jcfg, jnp.float64)

    # the last-chance update is the pipeline's only msckf_update call when
    # EKF features are on: count the features it uses in both packages
    counts = {"jax": [], "port": []}
    jax_msckf = jpipe.msckf_update

    def jax_spy(cfg, state, fj, use):
        jax.debug.callback(lambda n: counts["jax"].append(int(n)), jnp.sum(use))
        return jax_msckf(cfg, state, fj, use)

    def step(s, f):
        s, out = jpipe.filter_step(jcfg, s, f, chi2)
        return s, (out, s.features.in_state, s.features.anchor_slot)

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "msckf_update", jax_spy)
    try:
        _, (jout, j_in, j_anchor) = jax.jit(
            lambda s, fr: jax.lax.scan(step, s, fr))(
                st0, jax.tree.map(jnp.asarray, frames))
        jax.effects_barrier()
    finally:
        mp.undo()
    jout = jax.tree.map(np.asarray, jout)

    pcfg = FilterConfig(**CFG)
    pchi2 = ppipe.build_chi2_table(pcfg, torch.float64)
    ps = filter_state_from_numpy(state_to_numpy(st0), torch.float64, "cpu")
    port_msckf = ppipe.msckf_update

    def port_spy(cfg, state, fj, use):
        counts["port"].append(int(use.sum()))
        return port_msckf(cfg, state, fj, use)

    pouts, p_in, p_anchor = [], [], []
    mp.setattr(ppipe, "msckf_update", port_spy)
    try:
        for k in range(T):
            ps, out = ppipe.filter_step(pcfg, ps, port_frame(frames, k), pchi2)
            pouts.append(out)
            p_in.append(ps.features.in_state.numpy())
            p_anchor.append(ps.features.anchor_slot.numpy())
    finally:
        mp.undo()
    pout = ppipe.FrameOutput(*(torch.stack(x).numpy() for x in zip(*pouts)))
    return {"jax": (jout, events(np.asarray(j_in), np.asarray(j_anchor)),
                    counts["jax"]),
            "port": (pout, events(np.stack(p_in), np.stack(p_anchor)),
                     counts["port"])}


@pytest.mark.parametrize("field", ["p", "R", "v"])
def test_pose_matches_per_frame(runs, field):
    j = getattr(runs["jax"][0], field)
    p = getattr(runs["port"][0], field)
    err = np.abs(j - p).reshape(T, -1).max(axis=1)
    assert err.max() < TOL, (int(err.argmax()), float(err.max()))


@pytest.mark.parametrize("field", ["n_update_features", "zupt"])
def test_decisions_identical(runs, field):
    np.testing.assert_array_equal(getattr(runs["port"][0], field),
                                  getattr(runs["jax"][0], field))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_every_branch_fires(runs, pkg):
    out, (promoted, reanchored), last_chance = runs[pkg]
    assert out.n_update_features.sum() > 0, "stacked updates"
    assert out.zupt.sum() > 0, "ZUPT"
    assert promoted > 0, "promotions"
    assert reanchored > 0, "re-anchoring"
    assert len(last_chance) == T and sum(last_chance) > 0, "last-chance"


def test_last_chance_identical(runs):
    assert runs["port"][2] == runs["jax"][2]
    assert runs["port"][1] == runs["jax"][1]


def test_run_sequence_matches_frame_steps(runs):
    """run_sequence (the stacked-frames loop) gives the per-frame outputs
    of filter_step frame by frame, over the first 12 frames."""
    frames, st0 = sim_frames()
    pcfg = FilterConfig(**CFG)
    ps = filter_state_from_numpy(state_to_numpy(st0), torch.float64, "cpu")
    stacked = ppipe.FrameInput(*(torch.as_tensor(np.array(x[:12]))
                                 for x in frames))
    _, out = ppipe.run_sequence(pcfg, ps, stacked,
                                ppipe.build_chi2_table(pcfg, torch.float64))
    ref = runs["port"][0]
    for field in ("p", "R", "v", "n_update_features", "zupt"):
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      getattr(ref, field)[:12])
