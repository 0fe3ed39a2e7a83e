"""The port's sequence-parallel replay (parallel/temporal.py) against the JAX
package's.

tests/test_temporal.py's world (sw 10, 80 features, 120 frames, K = 4
blocks, float64, from __graft_entry__._build), the JAX states and frames
carried into the port:

* each gauge and preintegration function on the same seeded inputs,
  within 1e-10;
* seq_parallel_replay at n_iters = 2 with the covariance correction:
  p on every frame, the end state's p, R and P and the update counts
  within 1e-8 (measured: some 1e-10 m, the batched products' rounding,
  ROADMAP section 3 item 20);
* at a smaller size (sw 6, 40 features, 24 frames) the port's
  n_iters = K run against its own serial run_sequence within 1e-8, a
  two-device CPU mesh against none within 1e-9, and the MSCKF check.

Run as a script, ``python tests/test_torch_temporal.py
--jax-temporal-figures`` prints the JAX package's float64 CPU figures
that chip_smoke.py's phase 14 holds the card to (JAX_TEMPORAL): the
serial and sequence-parallel replays of the world
__graft_entry__._dryrun_real_shapes runs, on the frames the port's
synthetic.generate makes.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch.set_num_threads(1)

CFG_KW = dict(sw_size=10, max_features=80, max_track_len=6, imu_slab=12,
              observation_noise=0.004, tri_translation_threshold=-1.0)
SIM_KW = dict(n_frames=120, n_landmarks=300, max_obs=40, imu_slab=12, seed=0)
SMALL_CFG = dict(CFG_KW, sw_size=6, max_features=40)
SMALL_SIM = dict(SIM_KW, n_frames=24)
K = 4
FN_TOL = 1e-10
RUN_TOL = 1e-8


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _to_port_frames(frames):
    from orcvio_tpu_torch.filter.pipeline import FrameInput

    return FrameInput(*(torch.as_tensor(np.array(x)) for x in frames))


def _to_port_state(st):
    from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy

    return filter_state_from_numpy(state_to_numpy(st), torch.float64, "cpu")


@pytest.fixture(scope="module")
def world():
    """The JAX world of tests/test_temporal.py and its port copy."""
    jax = _jax()
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.filter.pipeline import build_chi2_table

    jcfg, jst, jframes, jchi2 = ge._build(CFG_KW, SIM_KW, jnp.float64)
    jst = jax.tree.map(jnp.asarray, jst)
    cfg = FilterConfig(**CFG_KW)
    return {"jax": (jcfg, jst, jframes, jchi2),
            "port": (cfg, _to_port_state(jst), _to_port_frames(jframes),
                     build_chi2_table(cfg, torch.float64, "cpu"))}


@pytest.fixture(scope="module")
def runs(world):
    """Both packages' seq_parallel_replay, K = 4, n_iters = 2, corrected."""
    from orcvio_tpu.parallel.temporal import seq_parallel_replay as jrun
    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    jend, jouts = jrun(*world["jax"], n_blocks=K, n_iters=2)
    pend, pouts = seq_parallel_replay(*world["port"], n_blocks=K, n_iters=2)
    return (jend, jouts), (pend, pouts)


def test_seq_parallel_matches_jax(runs):
    (jend, jouts), (pend, pouts) = runs
    assert pouts["p"].shape == (120, 3)
    for key in ("p", "R", "v", "t"):
        np.testing.assert_allclose(pouts[key].numpy(), np.asarray(jouts[key]),
                                   rtol=0, atol=RUN_TOL, err_msg=key)
    np.testing.assert_array_equal(pouts["n_update_features"].numpy(),
                                  np.asarray(jouts["n_update_features"]))
    assert int(pouts["n_update_features"].sum()) > 100
    np.testing.assert_allclose(pend.imu.p.numpy(), np.asarray(jend.imu.p),
                               rtol=0, atol=RUN_TOL)
    np.testing.assert_allclose(pend.imu.R.numpy(), np.asarray(jend.imu.R),
                               rtol=0, atol=RUN_TOL)
    np.testing.assert_allclose(pend.P.numpy(), np.asarray(jend.P), rtol=0,
                               atol=RUN_TOL)


def _gauges(rng, n):
    return [(rng.uniform(-np.pi, np.pi), rng.normal(size=3)) for _ in range(n)]


@pytest.fixture(scope="module")
def fn_inputs(runs):
    """A mid-flight JAX state (the parallel run's end, valid clones) and
    the right-perturbation config beside the left one."""
    (jend, _), _ = runs
    from dataclasses import replace

    from orcvio_tpu.config.core import FilterConfig as JCfg

    jcfg = JCfg(**CFG_KW)
    return {"left": jcfg,
            "right": replace(jcfg, use_larvio=False,
                             use_left_perturbation=False)}, jend


@pytest.mark.parametrize("side", ["left", "right"])
def test_gauge_functions_match_jax(fn_inputs, side):
    jax = _jax()
    import jax.numpy as jnp

    from orcvio_tpu.parallel import temporal as J
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.parallel import temporal as P

    cfgs, jst = fn_inputs
    jcfg = cfgs[side]
    cfg = FilterConfig(**{f: getattr(jcfg, f) for f in
                          ("sw_size", "max_features", "max_track_len",
                           "imu_slab", "observation_noise",
                           "tri_translation_threshold", "use_larvio",
                           "use_left_perturbation")})
    pst = _to_port_state(jst)
    rng = np.random.default_rng(7 + (side == "right"))
    (a1, d1), (a2, d2), (a3, d3) = _gauges(rng, 3)

    def near(ours, theirs, what):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=FN_TOL, err_msg=what)

    D = pst.P.shape[0]
    near(P.gauge_T(cfg, torch.tensor(a3, dtype=torch.float64), D,
                   torch.float64),
         J.gauge_T(jcfg, jnp.float64(a3), D, jnp.float64), "gauge_T")
    anchor = rng.normal(size=3)
    for a in (None, anchor):
        ja = None if a is None else jnp.asarray(a)
        pa = None if a is None else torch.as_tensor(a)
        near(P.gauge_basis(cfg, pst, pa),
             jax.jit(functools.partial(J.gauge_basis, jcfg))(jst, ja),
             f"gauge_basis anchor={a is not None}")
        near(P.gauge_covariance(cfg, pst, pa),
             jax.jit(functools.partial(J.gauge_covariance, jcfg))(jst, ja),
             f"gauge_covariance anchor={a is not None}")
    if side == "right":
        return  # the rest has no perturbation-dependent code

    jg = [J.Gauge(jnp.float64(a), jnp.asarray(d)) for a, d in
          ((a1, d1), (a2, d2))]
    pg = [P.Gauge(torch.tensor(a, dtype=torch.float64), torch.as_tensor(d))
          for a, d in ((a1, d1), (a2, d2))]
    jc, pc = J.gauge_compose(*jg), P.gauge_compose(*pg)
    near(pc.psi, jc.psi, "compose psi")
    near(pc.dp, jc.dp, "compose dp")

    japply = jax.jit(functools.partial(J.gauge_apply, jcfg))
    jmoved = japply(jst, jg[0])
    pmoved = P.gauge_apply(cfg, pst, pg[0])
    for name, ours, theirs in (("R", pmoved.imu.R, jmoved.imu.R),
                               ("v", pmoved.imu.v, jmoved.imu.v),
                               ("p", pmoved.imu.p, jmoved.imu.p),
                               ("fej p", pmoved.imu_fej_now.p,
                                jmoved.imu_fej_now.p),
                               ("clones R", pmoved.clones.R,
                                jmoved.clones.R),
                               ("clones p", pmoved.clones.p, jmoved.clones.p),
                               ("clones p_fej", pmoved.clones.p_fej,
                                jmoved.clones.p_fej),
                               ("P", pmoved.P, jmoved.P)):
        near(ours, theirs, f"gauge_apply {name}")
    jd = J.gauge_diff(jmoved, jst)
    pd = P.gauge_diff(pmoved, pst)
    near(pd.psi, jd.psi, "diff psi")
    near(pd.dp, jd.dp, "diff dp")
    np.testing.assert_allclose(float(pd.psi), a1, atol=1e-9)

    Q = rng.normal(size=(4, 4)) * 1e-3
    Q = Q @ Q.T
    near(P.inflate_gauge(cfg, pst, torch.as_tensor(Q),
                         torch.as_tensor(anchor)).P,
         jax.jit(functools.partial(J.inflate_gauge, jcfg))(
             jst, jnp.asarray(Q), jnp.asarray(anchor)).P, "inflate_gauge")
    near(P._transport_gauge_cov(torch.as_tensor(Q),
                                torch.tensor(a2, dtype=torch.float64),
                                torch.as_tensor(d2)),
         J._transport_gauge_cov(jnp.asarray(Q), jnp.float64(a2),
                                jnp.asarray(d2)), "_transport_gauge_cov")


def test_starts_and_stitch_match_jax(world):
    jax = _jax()
    import jax.numpy as jnp

    from orcvio_tpu.parallel import temporal as J
    from orcvio_tpu_torch.parallel import temporal as P
    from orcvio_tpu_torch.tree import tree_index, tree_stack

    jcfg, jst, jframes, _ = world["jax"]
    cfg, pst, pframes, _ = world["port"]
    jstarts = jax.jit(lambda s, f: J.initial_starts(jcfg, s, f, K))(
        jst, jframes)
    pstarts = P.initial_starts(cfg, pst, pframes, K)
    for name in ("R", "v", "p"):
        np.testing.assert_allclose(
            getattr(pstarts.imu, name).numpy(),
            np.asarray(getattr(jstarts.imu, name)), rtol=0, atol=FN_TOL,
            err_msg=f"initial_starts {name}")
    np.testing.assert_array_equal(pstarts.t.numpy(), np.asarray(jstarts.t))
    # the blocks' starts move away from state0 (the preintegration ran)
    assert float(np.abs(np.asarray(jstarts.imu.p[3] - jstarts.imu.p[0])).max()
                 ) > 0.1

    # ends: each start moved by a seeded gauge, its P scaled
    rng = np.random.default_rng(11)
    jends, pends = [], []
    for b, (a, d) in enumerate(_gauges(rng, K)):
        js = jax.tree.map(lambda x: x[b], jstarts)
        js = J.gauge_apply(jcfg, js, J.Gauge(jnp.float64(a), jnp.asarray(d)))
        jends.append(js.replace(P=js.P * (1.0 + 0.1 * b)))
        ps = P.gauge_apply(cfg, tree_index(pstarts, b),
                           P.Gauge(torch.tensor(a, dtype=torch.float64),
                                   torch.as_tensor(d)))
        pends.append(ps.replace(P=ps.P * (1.0 + 0.1 * b)))
    jends = jax.tree.map(lambda *xs: jnp.stack(xs), *jends)
    jnew, jdel = jax.jit(functools.partial(J._stitch, jcfg))(
        jst, jends, jstarts)
    pnew, pdel = P._stitch(cfg, pst, tree_stack(pends), pstarts)
    for name, ours, theirs in (("psi", pdel.psi, jdel.psi),
                               ("dp", pdel.dp, jdel.dp),
                               ("starts p", pnew.imu.p, jnew.imu.p),
                               ("starts R", pnew.imu.R, jnew.imu.R),
                               ("starts P", pnew.P, jnew.P)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=FN_TOL, err_msg=f"_stitch {name}")


@pytest.fixture(scope="module")
def small():
    """The smaller world on the port alone, and its serial replay."""
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.synthetic import SimConfig, initialized_run
    from orcvio_tpu_torch.filter.pipeline import run_sequence

    cfg = FilterConfig(**SMALL_CFG)
    st, frames, chi2 = initialized_run(cfg, SimConfig(**SMALL_SIM),
                                       torch.float64, "cpu")
    return cfg, st, frames, chi2, run_sequence(cfg, st, frames, chi2)


def test_k_iterations_match_the_serial_replay(small):
    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    cfg, st, frames, chi2, (end_s, outs_s) = small
    end_p, outs_p = seq_parallel_replay(cfg, st, frames, chi2, n_blocks=K,
                                        n_iters=K)
    np.testing.assert_allclose(outs_p["p"].numpy(), outs_s.p.numpy(), rtol=0,
                               atol=RUN_TOL)
    np.testing.assert_array_equal(outs_p["n_update_features"].numpy(),
                                  outs_s.n_update_features.numpy())
    for ours, theirs in ((end_p.imu.p, end_s.imu.p), (end_p.imu.R, end_s.imu.R),
                         (end_p.P, end_s.P)):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=0,
                                   atol=RUN_TOL)
    assert int(outs_s.n_update_features.sum()) > 0


def test_two_device_mesh_matches_one(small):
    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    cfg, st, frames, chi2, _ = small
    cpu = torch.device("cpu")
    end_m, outs_m = seq_parallel_replay(cfg, st, frames, chi2, n_blocks=K,
                                        n_iters=1, mesh=[cpu, cpu])
    end_v, outs_v = seq_parallel_replay(cfg, st, frames, chi2, n_blocks=K,
                                        n_iters=1)
    np.testing.assert_allclose(outs_m["p"].numpy(), outs_v["p"].numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(end_m.P.numpy(), end_v.P.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("flag", [{"ekf_feature_cap": 8},
                                  {"nuisance_cap": 2}], ids=str)
def test_rejects_state_features(small, flag):
    from dataclasses import replace

    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    cfg, st, frames, chi2, _ = small
    with pytest.raises(ValueError, match="MSCKF"):
        seq_parallel_replay(replace(cfg, **flag), st, frames, chi2,
                            n_blocks=K)


@pytest.mark.slow
def test_gauge_covariance_calibrated(world):
    """tests/test_temporal.py::TestGaugeCovarianceCorrection on the port:
    with a tight prior (1e-8) the end covariance's gauge block at n_iters
    = 2 and 3 lies within the JAX test's bands of the serial filter's."""
    from orcvio_tpu_torch.filter.pipeline import run_sequence
    from orcvio_tpu_torch.parallel.temporal import (gauge_covariance,
                                                    seq_parallel_replay)

    cfg, st, frames, chi2 = world["port"]
    st = st.replace(P=torch.eye(st.P.shape[0], dtype=torch.float64) * 1e-8)
    end_s, _ = run_sequence(cfg, st, frames, chi2)
    anchor = end_s.imu.p
    d_s = torch.diagonal(gauge_covariance(cfg, end_s, anchor)).numpy()
    w = slice(0, 3)
    for n_iters in (2, 3):
        diag = {}
        for corrected in (True, False):
            end, _ = seq_parallel_replay(cfg, st, frames, chi2, n_blocks=K,
                                         n_iters=n_iters,
                                         gauge_cov_correction=corrected)
            diag[corrected] = torch.diagonal(
                gauge_covariance(cfg, end, anchor)).numpy()
        assert np.all(diag[False][w] <= d_s[w] * 1.05), (n_iters, diag, d_s)
        assert np.all(diag[True][w] >= 0.35 * d_s[w]), (n_iters, diag, d_s)
        assert np.all(diag[True][w] <= 2.5 * d_s[w]), (n_iters, diag, d_s)


# --------------------------------------------------------------------------
# script mode: the JAX figures of chip_smoke.py's phase 14
# --------------------------------------------------------------------------

FULL_CFG = dict(sw_size=20, max_features=150, max_track_len=6, imu_slab=10,
                observation_noise=0.004, tri_translation_threshold=-1.0)
FULL_SIM = dict(n_frames=300, n_landmarks=400, max_obs=60, imu_slab=10,
                seed=0)


def jax_temporal_figures():
    """The JAX package's serial and sequence-parallel (K = 4, n_iters = 2,
    corrected) float64 replays of FULL_SIM on the CPU, on the port's
    frames and initial state: per-frame update counts, the end position,
    the RMSE to the ground truth and the parallel run's mean distance to
    the serial one."""
    import json

    jax = _jax()
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from orcvio_tpu.config.core import FilterConfig as JCfg
    from orcvio_tpu.filter.pipeline import build_chi2_table as jchi2
    from orcvio_tpu.filter.pipeline import FrameInput as JFrame
    from orcvio_tpu.filter.pipeline import run_sequence as jserial
    from orcvio_tpu.filter.state import FilterState as JState
    from orcvio_tpu.parallel.temporal import seq_parallel_replay as jpar
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.synthetic import (SimConfig, generate,
                                                   initialized_run)

    cfg = FilterConfig(**FULL_CFG)
    sim = SimConfig(**FULL_SIM)
    st, frames, _ = initialized_run(cfg, sim, torch.float64, "cpu")
    gt_p = generate(sim, dtype=torch.float64, device="cpu").gt_p.numpy()
    jcfg = JCfg(**FULL_CFG)
    js = JState.create(jcfg, jnp.float64)
    imu = js.imu.replace(R=jnp.asarray(st.imu.R.numpy()),
                         p=jnp.asarray(st.imu.p.numpy()),
                         v=jnp.asarray(st.imu.v.numpy()))
    js = js.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                    R_b2c=jnp.asarray(st.R_b2c.numpy()),
                    t_c_b=jnp.asarray(st.t_c_b.numpy()),
                    initialized=jnp.ones((), bool))
    jf = JFrame(*(jnp.asarray(x.numpy()) for x in frames))
    chi2 = jchi2(jcfg, jnp.float64)
    end_s, outs_s = jax.jit(lambda s, f: jserial(jcfg, s, f, chi2))(js, jf)
    end_p, outs_p = jpar(jcfg, js, jf, chi2, n_blocks=K, n_iters=2)

    def rmse(p):
        return float(np.sqrt(((np.asarray(p) - gt_p) ** 2).sum(1).mean()))

    out = {}
    for name, end, p, n in (
            ("serial", end_s, outs_s.p, outs_s.n_update_features),
            ("parallel", end_p, outs_p["p"], outs_p["n_update_features"])):
        out[name] = {"end_p": np.asarray(end.imu.p).tolist(),
                     "rmse_m": rmse(p),
                     "n_update": np.asarray(n).astype(int).tolist()}
    out["parallel"]["mean_gap_m"] = float(np.linalg.norm(
        np.asarray(outs_p["p"]) - np.asarray(outs_s.p), axis=1).mean())
    print(json.dumps(out))


if __name__ == "__main__":
    if "--jax-temporal-figures" in sys.argv:
        jax_temporal_figures()
    else:
        sys.exit("usage: python tests/test_torch_temporal.py "
                 "--jax-temporal-figures")
