"""The port's many-sequence replay (parallel/replay.py) against the JAX
package's.

B = 4 rows, each its own synthetic sequence (SimConfig seeds 3-6) from
an initialized state, built as tests/test_parallel.py:make_ready_state
builds one, in float64. The JAX package runs them through its
sharded_replay_fn on a 2-device CPU mesh (the virtual devices of
tests/conftest.py); the port through its sharded_replay_fn on the CPU
with the batch as one chunk and as two. p agrees within 1e-8 m on every
frame of every row, and the two chunkings give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.dataio.synthetic import SimConfig, generate, trajectory_pose
from orcvio_tpu.filter.pipeline import build_chi2_table as jax_chi2
from orcvio_tpu.filter.state import FilterState as JaxFilterState
from orcvio_tpu.parallel import replay as jreplay
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
from orcvio_tpu_torch.tree import tree_index, tree_stack
from orcvio_tpu_torch.parallel import replay as preplay

torch.set_num_threads(1)

B, T = 4, 20
SEEDS = (3, 4, 5, 6)
CFG = dict(sw_size=6, max_features=40, max_track_len=4, imu_slab=12,
           observation_noise=0.004, tri_translation_threshold=-1.0)
P_TOL = 1e-8
R_B2C = np.asarray([[0.0, -1, 0], [0, 0, -1], [1.0, 0, 0]])


def ready_state(cfg, sim):
    """tests/test_parallel.py:make_ready_state's state and frames."""
    data = generate(sim, R_b2c=jnp.asarray(R_B2C))
    st = JaxFilterState.create(cfg, jnp.float64)
    R0, p0 = trajectory_pose(sim, jnp.asarray(0.0))
    v0 = jax.jacobian(lambda t: trajectory_pose(sim, t)[1])(jnp.asarray(0.0))
    imu = st.imu.replace(R=R0, p=p0, v=v0)
    d = np.asarray(cfg.initial_cov_diag())
    d[:15] = 1e-6
    st = st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                    R_b2c=jnp.asarray(R_B2C), P=jnp.asarray(np.diag(d)),
                    initialized=jnp.ones((), bool))
    return st, data.frames


@pytest.fixture(scope="module")
def rows():
    """The B rows' JAX states and frames, stacked."""
    jcfg = JaxFilterConfig(**CFG)
    made = [ready_state(jcfg, SimConfig(n_frames=T, n_landmarks=150,
                                        max_obs=30, imu_slab=12, seed=s))
            for s in SEEDS]
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    return (jax.tree.map(stack, *(m[0] for m in made)),
            jax.tree.map(stack, *(m[1] for m in made)))


@pytest.fixture(scope="module")
def jax_p(rows):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jcfg = JaxFilterConfig(**CFG)
    mesh = jreplay.make_mesh(2)
    states, frames = (jreplay.shard_batch(x, mesh) for x in rows)
    fn = jreplay.sharded_replay_fn(jcfg, mesh)
    _, outs = fn(states, frames, jax_chi2(jcfg, jnp.float64))
    return np.asarray(outs.p)


@pytest.fixture(scope="module")
def port_runs(rows):
    """The port's final states and outputs with the batch as one chunk and
    as two, on the CPU."""
    cfg = FilterConfig(**CFG)
    states = tree_stack([filter_state_from_numpy(
        state_to_numpy(jax.tree.map(lambda x: x[b], rows[0])), torch.float64,
        "cpu") for b in range(B)])
    frames = FrameInput(*(torch.as_tensor(np.array(x)) for x in rows[1]))
    chi2 = build_chi2_table(cfg, torch.float64, "cpu")
    cpu = torch.device("cpu")
    return {n: preplay.sharded_replay_fn(cfg, [cpu] * n)(states, frames, chi2)
            for n in (1, 2)}


def test_shard_batch_cuts_contiguous_chunks():
    cpu = torch.device("cpu")
    x = torch.arange(5)
    assert [c.tolist() for c in preplay.shard_batch(x, [cpu] * 2)] == [
        [0, 1, 2], [3, 4]]
    assert [c.tolist() for c in preplay.shard_batch(x[:1], [cpu] * 2)] == [
        [0]]


@pytest.mark.parametrize("chunks", [1, 2])
def test_rows_match_jax_sharded_replay(jax_p, port_runs, chunks):
    _, outs = port_runs[chunks]
    p = outs.p.numpy()
    assert p.shape == jax_p.shape == (B, T, 3)
    err = np.abs(p - jax_p).max(axis=(1, 2))
    assert err.max() < P_TOL, err
    # the rows are different sequences
    assert np.abs(jax_p[0] - jax_p[1]).max() > 1e-3


def test_chunkings_agree_bit_for_bit(port_runs):
    (s1, o1), (s2, o2) = port_runs[1], port_runs[2]
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    assert torch.equal(tree_index(s1, 3).P, tree_index(s2, 3).P)
    assert int(o1.n_update_features.sum()) > 0
