"""The port's feature-parallel update (parallel/feature_parallel.py) against
the JAX package's.

tests/test_parallel.py's two cases (capacity 16 and capacity 21, the
latter not a multiple of the 8 shards): five clones observing seeded
landmarks, built by the JAX package and carried into the port in float64.
The port's 8-shard update matches the JAX package's feature_parallel_update
on its 8-device virtual CPU mesh, and the port's one-shot
information_update, within 1e-8. Two gloo processes, each taking 4 of
the 8 shards and summing the information pair with all_reduce, end with
the one-process update within 1e-10, and gather each other's rows.
"""
import functools
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.filter.state import FilterState as JaxFilterState
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter.tracks import CompactTracks
from orcvio_tpu_torch.filter.update import (feature_jacobians,
                                            information_update)
from orcvio_tpu_torch.parallel.feature_parallel import (
    feature_parallel_update, information_from_jacobians, pad_feature_axis)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-8
SHARDS = 8


@functools.lru_cache(maxsize=None)
def jax_case(F, seed):
    """tests/test_parallel.py's state, tracks, positions and use mask (built
    once a case, its steps jitted)."""
    from orcvio_tpu.filter import features as feat
    from orcvio_tpu.filter.augment import cam_poses, state_augmentation
    from orcvio_tpu.filter.tracks import compact_tracks
    from orcvio_tpu.filter.triangulation import triangulate
    from orcvio_tpu.math import so3

    rng = np.random.default_rng(seed)
    cfg_kw = dict(sw_size=6, max_features=F, max_track_len=4,
                  observation_noise=0.004, tri_translation_threshold=-1.0)
    cfg = JaxFilterConfig(**cfg_kw)
    augment = jax.jit(functools.partial(state_augmentation, cfg))
    poses = jax.jit(cam_poses)
    observe = jax.jit(feat.add_observations)
    exp = jax.jit(so3.exp)
    st = JaxFilterState.create(cfg, jnp.float64)
    lm = rng.normal(size=(F, 3)) * 2 + [0, 0, 8]
    for i in range(5):
        R = exp(jnp.asarray(rng.normal(size=3) * 0.05))
        p = jnp.asarray([0.4 * i, 0.05 * i, 0.0])
        imu = st.imu.replace(R=R, p=p)
        st = st.replace(imu=imu, imu_fej_now=imu, t=jnp.asarray(float(i)))
        st = augment(st)
        R_c2w, t_c_w = poses(st)
        pc = (lm - np.asarray(t_c_w[i])) @ np.asarray(R_c2w[i])
        uv = jnp.asarray(pc[:, :2] / pc[:, 2:3]
                         + rng.normal(size=(F, 2)) * 1e-3)
        tb, _ = observe(st.features, jnp.asarray(i),
                        jnp.arange(F, dtype=jnp.int32), uv, uv * 0,
                        jnp.ones(F, bool))
        st = st.replace(features=tb)
    st = st.replace(P=jnp.eye(cfg.state_dim, dtype=jnp.float64) * 1e-2)

    @jax.jit
    def finish(st):
        ct = compact_tracks(st.features, st.clones.order, cfg.max_track_len)
        R_c2w, t_c_w = cam_poses(st)
        tri = triangulate(cfg, ct, R_c2w, t_c_w)
        return ct, tri.p_world, tri.valid & (2 * ct.n_obs > 3)

    ct, p_w, use = finish(st)
    return cfg_kw, cfg, st, ct, p_w, use


def port_inputs(st, ct, p_w, use):
    return (filter_state_from_numpy(state_to_numpy(st), torch.float64, "cpu"),
            CompactTracks(*(torch.as_tensor(np.array(x)) for x in ct))._replace(
                slot=torch.as_tensor(np.array(ct.slot)).long()),
            torch.as_tensor(np.array(p_w)), torch.as_tensor(np.array(use)))


@pytest.fixture(scope="module", params=[(16, 4), (21, 6)],
                ids=["capacity16", "capacity21"])
def case(request):
    if len(jax.devices()) < SHARDS:
        pytest.skip("needs 8 virtual devices")
    from orcvio_tpu.parallel.feature_parallel import \
        feature_parallel_update as jfpu
    from orcvio_tpu.parallel.replay import make_mesh

    cfg_kw, jcfg, st, ct, p_w, use = jax_case(*request.param)
    assert int(use.sum()) > 8
    jst, jdx = jfpu(jcfg, make_mesh(SHARDS, axis="fp"))(st, ct, p_w, use)
    return cfg_kw, (st, ct, p_w, use), (np.asarray(jst.P), np.asarray(jdx))


def test_matches_jax_and_the_one_shot_update(case):
    cfg_kw, jin, (jP, jdx) = case
    cfg = FilterConfig(**cfg_kw)
    st, ct, p_w, use = port_inputs(*jin)
    st_c, dx_c = feature_parallel_update(cfg, n_shards=SHARDS)(st, ct, p_w,
                                                              use)
    np.testing.assert_allclose(dx_c.numpy(), jdx, rtol=0, atol=TOL)
    np.testing.assert_allclose(st_c.P.numpy(), jP, rtol=0, atol=TOL)
    fj = feature_jacobians(cfg, st, ct, p_w)
    st_b, dx_b = information_update(cfg, st,
                                    *information_from_jacobians(fj, use))
    np.testing.assert_allclose(dx_c.numpy(), dx_b.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(st_c.P.numpy(), st_b.P.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(st_c.imu.p.numpy(), st_b.imu.p.numpy(),
                               rtol=0, atol=TOL)
    # the shards over a two-device CPU mesh: the same update
    cpu = torch.device("cpu")
    st_m, dx_m = feature_parallel_update(cfg, mesh=[cpu, cpu],
                                         n_shards=SHARDS)(st, ct, p_w, use)
    np.testing.assert_allclose(dx_m.numpy(), dx_c.numpy(), rtol=0, atol=1e-12)


def test_padding_adds_false_rows():
    cfg_kw, _, st, ct, p_w, use = jax_case(21, 6)
    _, pct, pp, pu = port_inputs(st, ct, p_w, use)
    ct2, p2, u2 = pad_feature_axis(pct, pp, pu, SHARDS)
    assert u2.shape == (24,) and not bool(u2[21:].any())
    assert ct2.uv.shape[0] == 24 and p2.shape == (24, 3)
    assert torch.equal(ct2.slot[:21], pct.slot)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy
from orcvio_tpu_torch.filter.tracks import CompactTracks
from orcvio_tpu_torch.parallel.feature_parallel import feature_parallel_update
from orcvio_tpu_torch.parallel.multihost import (all_gather_rows,
                                                 maybe_initialize,
                                                 process_rank)
backend = maybe_initialize()
with open({inp!r}, "rb") as f:
    d = pickle.load(f)
st = filter_state_from_numpy(d["state"], torch.float64, "cpu")
ct = CompactTracks(*(torch.as_tensor(x) for x in d["ct"]))
st2, dx = feature_parallel_update(FilterConfig(**d["cfg"]), n_shards=8)(
    st, ct, torch.as_tensor(d["p_w"]), torch.as_tensor(d["use"]))
with open({out!r} % process_rank(), "wb") as f:
    pickle.dump({{"P": st2.P.numpy(), "dx": dx.numpy(), "backend": backend,
                  "rows": all_gather_rows(dx[None]).numpy()}}, f)
torch.distributed.destroy_process_group()
"""


def test_two_gloo_processes_match_one(tmp_path):
    """Each worker is killed after 100 s, so a hang fails the test."""
    cfg_kw, _, st, ct, p_w, use = jax_case(21, 6)
    pst, pct, pp, pu = port_inputs(st, ct, p_w, use)
    inp, out = tmp_path / "in.pkl", str(tmp_path / "out%d.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"cfg": cfg_kw, "state": state_to_numpy(pst),
                     "ct": [x.numpy() for x in pct], "p_w": pp.numpy(),
                     "use": pu.numpy()}, f)
    port = _free_port()
    code = WORKER.format(root=str(ROOT), inp=str(inp), out=out)
    procs = []
    for rank in range(2):
        env = dict(os.environ, ORCVIO_COORDINATOR=f"127.0.0.1:{port}",
                   ORCVIO_NUM_PROCESSES="2", ORCVIO_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=100)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    res = []
    for rank in range(2):
        with open(out % rank, "rb") as f:
            res.append(pickle.load(f))
    assert [r["backend"] for r in res] == ["gloo", "gloo"]
    one_st, one_dx = feature_parallel_update(FilterConfig(**cfg_kw),
                                             n_shards=SHARDS)(pst, pct, pp, pu)
    for r in res:
        np.testing.assert_allclose(r["dx"], one_dx.numpy(), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(r["P"], one_st.P.numpy(), rtol=0,
                                   atol=1e-10)
    np.testing.assert_array_equal(res[0]["P"], res[1]["P"])
    # every process's rows, in rank order, on every process
    for r in res:
        assert r["rows"].shape == (2, one_dx.shape[0])
        np.testing.assert_array_equal(r["rows"][0], res[0]["dx"])
        np.testing.assert_array_equal(r["rows"][1], res[1]["dx"])
