"""The port's host loop and CLI against the JAX package's.

* run_image_sequence on a 320x240 rendered stream with no static start
  (chip_smoke.py's dynamic stream, 22 frames), in
  float64 on the CPU, with KLT_EPS = 0 and both packages' RANSAC draws the
  JAX package's (the tracker's per frame, and each dynamic attempt's from
  jax.random.PRNGKey(frame)): the same dynamic attempts with the same
  outcomes, the same init frame, identical update counts and p within
  1e-6 m on every frame.
* vio.run_vio (the frame loop over stacked frames) against the JAX
  package's lax.scan on the JAX package's generate's frames (the port's
  generate gives the same observations and IMU noise; its IMU is the
  closed form's, the JAX package's a finite difference): a static start,
  static init, then the filter; p, R, v within 1e-8, identical update
  counts and ZUPT flags.
* run_vio.main --device cpu end to end on tiny bytes from the port's
  writer, once --staged and once as the host loop: the TUM file it writes
  reads back with read_tum, and the reader it used is reported.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import orcvio_tpu.init.dynamic as jdyn  # noqa: E402
from orcvio_tpu import run_vio as jrun  # noqa: E402
from orcvio_tpu import vio as jvio  # noqa: E402
from orcvio_tpu.config.core import FilterConfig as JaxConfig  # noqa: E402
from orcvio_tpu.dataio import synthetic as jsyn  # noqa: E402
from orcvio_tpu.filter.pipeline import build_chi2_table as jchi2  # noqa: E402
from orcvio_tpu.frontend.tracker import \
    TrackerConfig as JaxTracker  # noqa: E402
from orcvio_tpu_torch import run_vio as prun  # noqa: E402
from orcvio_tpu_torch import vio as pvio  # noqa: E402
from orcvio_tpu_torch.config.core import FilterConfig  # noqa: E402
from orcvio_tpu_torch.dataio import euroc_writer as pwriter  # noqa: E402
from orcvio_tpu_torch.dataio import synthetic as psyn  # noqa: E402
from orcvio_tpu_torch.dataio.euroc import read_tum  # noqa: E402
from orcvio_tpu_torch.filter.pipeline import build_chi2_table  # noqa: E402
from orcvio_tpu_torch.frontend import klt as pklt  # noqa: E402
from orcvio_tpu_torch.frontend.tracker import TrackerConfig  # noqa: E402

torch.set_num_threads(1)

H, W, N = 240, 320, 48
K_SMALL = (200.0, 200.0, 160.0, 120.0)
T = 22
DYN_SIM = cs.DYN_SIM
TRACKER = {**cs.TRACKER, "height": H, "width": W, "capacity": N,
           "pyramid_levels": 2, "grid_rows": 4, "grid_cols": 4, "K": K_SMALL,
           "min_distance": 10.0}
FILTER = {**cs.BENCH_FILTER, "sw_size": 8, "max_features": 48,
          "max_update_features": 8, "ekf_feature_cap": 6,
          "static_image_num": 5, "static_min_matches": 10}
P_TOL = 1e-6


def _gumbels(key, steps, shape):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float64)))
    return torch.as_tensor(np.stack(out))


@pytest.fixture(scope="module")
def stream():
    wc = pwriter.WriterConfig(cam=pwriter.CameraModel(W, H, *K_SMALL))
    sim = psyn.SimConfig(n_frames=T, **DYN_SIM)
    return cs.bench_inputs(pwriter.make_stream(sim, wc, device="cpu"))


@pytest.fixture(scope="module")
def runs(stream):
    images, ft, it, ig, ia, im = stream
    R_b2c = pwriter.R_B2C_DOWN
    t_c_b = np.asarray(pwriter.WriterConfig().t_c_b)
    mp = pytest.MonkeyPatch()
    jattempts = []
    attempt = jdyn.flexible_dynamic_attempt
    jit_init = jax.jit(jdyn.dynamic_initialize, static_argnums=0)

    def spy(cfg, window, R, t, key, *a, **kw):
        res = attempt(cfg, window, R, t, key, *a, **kw)
        jattempts.append((int(np.asarray(key)[-1]),
                          None if res is None else bool(res.ok)))
        return res

    mp.setattr(jdyn, "flexible_dynamic_attempt", spy)
    mp.setattr(jdyn, "dynamic_initialize", jit_init)
    mp.setattr(pklt, "KLT_EPS", 0.0)
    try:
        jres = jrun.run_image_sequence(
            JaxConfig(**FILTER), JaxTracker(**TRACKER),
            lambda k: images[k].astype(np.float32), ft, it, ig, ia, im,
            R_b2c, t_c_b, dtype=jnp.float64)
        pres = prun.run_image_sequence(
            FilterConfig(**FILTER), TrackerConfig(**TRACKER),
            lambda k: images[k].astype(np.float32), ft, it, ig, ia, im,
            R_b2c, t_c_b, dtype=torch.float64, device="cpu",
            ransac_gumbel=_gumbels(jax.random.PRNGKey(0), T, (128, 8, N)),
            dynamic_gumbel=lambda k, n: torch.as_tensor(np.array(
                jax.random.gumbel(jax.random.PRNGKey(k), (256, 8, n),
                                  jnp.float64))))
    finally:
        mp.undo()
    return jres, jattempts, pres


def test_dynamic_attempts_identical(runs):
    _, jattempts, pres = runs
    assert [k for k, _ in jattempts] == [10, 15, 20][:len(jattempts)]
    assert pres["dynamic_attempts"] == jattempts
    assert any(ok for _, ok in jattempts)  # the stream initializes


def test_init_on_the_same_frame(runs):
    jres, jattempts, pres = runs
    k0 = next(k for k, ok in jattempts if ok)
    moved = np.abs(jres["R"] - np.eye(3)).reshape(T, -1).max(1) > 0
    assert int(np.argmax(moved)) == k0
    np.testing.assert_array_equal(pres["initialized"], np.arange(T) >= k0)
    assert pres["final_state"].host_initialized


def test_updates_and_poses_match(runs):
    jres, _, pres = runs
    np.testing.assert_array_equal(pres["n_updates"], jres["n_updates"])
    np.testing.assert_array_equal(pres["t"], jres["t"])
    err = np.abs(pres["p"] - jres["p"]).max(1)
    assert err.max() < P_TOL, (int(err.argmax()), float(err.max()))
    np.testing.assert_allclose(pres["R"], jres["R"], rtol=0, atol=P_TOL)


VIO_SIM = dict(n_frames=36, n_landmarks=120, max_obs=40, imu_slab=24, seed=3,
               uv_noise=0.001, static_time=0.4, ramp_time=1.0, fov_limit=0.9)
VIO_CFG = dict(sw_size=8, max_features=48, max_track_len=6, imu_slab=24,
               max_update_features=8, use_larvio=True,
               use_left_perturbation=False, use_closed_form_cov_prop=True,
               if_zupt=True, feature_idp_dim=1, ekf_feature_cap=6,
               observation_noise=0.004, tri_translation_threshold=-1.0,
               zupt_max_feature_dis=0.012, static_image_num=5,
               static_min_matches=10)


def test_run_vio_matches_jax():
    R_b2c = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t_c_b = np.asarray([0.05, 0.02, 0.0])
    jframes = jsyn.generate(jsyn.SimConfig(**VIO_SIM), R_b2c=R_b2c,
                            t_c_b=t_c_b).frames
    jcfg = JaxConfig(**VIO_CFG)
    js = jvio.VioState.create(jcfg, 40, jnp.float64)
    js = js.replace(filter=js.filter.replace(R_b2c=jnp.asarray(R_b2c),
                                             t_c_b=jnp.asarray(t_c_b)))
    _, jout = jax.jit(lambda s, f: jvio.run_vio(
        jcfg, s, f, jchi2(jcfg, jnp.float64)))(js, jframes)
    # the port's generate differentiates the trajectory in closed form, the
    # JAX package's by finite differences (which err by up to 1e-2 where
    # the stencil straddles an end of the static-start ramp): the same
    # observations and the same IMU noise; both loops run the JAX frames
    sim = psyn.SimConfig(**VIO_SIM)
    ours = psyn.generate(sim, R_b2c, t_c_b, torch.float64,
                         device="cpu").frames
    np.testing.assert_array_equal(ours.uvs.numpy(), np.asarray(jframes.uvs))
    t = np.asarray(jframes.imu_t).reshape(-1)
    m = np.asarray(jframes.imu_mask).reshape(-1)
    exact = psyn.kinematics_np(sim, t)[1:]
    fd = jsyn.imu_np(jsyn.SimConfig(**VIO_SIM), t)
    for field, a, b in zip(("imu_gyro", "imu_acc"), exact, fd):
        diff = (getattr(ours, field).numpy()
                - np.asarray(getattr(jframes, field))).reshape(-1, 3)
        np.testing.assert_allclose(diff[m], (a - b)[m], rtol=0, atol=1e-12)
    pframes = type(ours)(**{f: torch.as_tensor(np.asarray(getattr(jframes,
                                                                  f)))
                            for f in ours._fields})
    cfg = FilterConfig(**VIO_CFG)
    ps = pvio.VioState.create(cfg, 40, torch.float64, device="cpu")
    ps = ps.replace(filter=ps.filter.replace(
        R_b2c=torch.as_tensor(R_b2c), t_c_b=torch.as_tensor(t_c_b)))
    pstate, pout = pvio.run_vio(cfg, ps, pframes,
                                build_chi2_table(cfg, torch.float64, "cpu"))
    assert pstate.host_initialized
    for field in ("n_update_features", "zupt"):
        np.testing.assert_array_equal(getattr(pout, field).numpy(),
                                      np.asarray(getattr(jout, field)))
    assert np.asarray(jout.n_update_features).sum() > 0
    for field in ("p", "R", "v"):
        np.testing.assert_allclose(getattr(pout, field).numpy(),
                                   np.asarray(getattr(jout, field)), rtol=0,
                                   atol=1e-8)


@pytest.fixture(scope="module")
def tiny_bytes(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    sim = psyn.SimConfig(n_frames=12, **{**cs.BENCH_SIM, "static_time": 0.3})
    wc = pwriter.WriterConfig(cam=pwriter.CameraModel(
        width=160, height=120, fx=100.0, fy=100.0, cx=80.0, cy=60.0),
        tex_size=512)
    pwriter.write_euroc_dataset(str(d), sim, wc, device="cpu")
    pwriter.write_reference_config(str(d / "config.yaml"), sim, wc,
                                   max_features_num=32, min_distance=8)
    return d


@pytest.mark.parametrize("staged", [True, False])
def test_main_runs_end_to_end_on_cpu(tiny_bytes, tmp_path, staged, capsys):
    out = tmp_path / "traj.txt"
    summary = prun.main(["--euroc", str(tiny_bytes), "--device", "cpu",
                         "--out", str(out)] + (["--staged"] if staged else []))
    printed = capsys.readouterr().out
    assert f"reader: {summary['reader']}" in printed
    assert "ATE se3" in printed and "ATE posyaw" in printed
    t, p, q = read_tum(str(out))
    assert t.shape == (12,) and p.shape == (12, 3) and q.shape == (12, 4)
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, summary["result"]["p"], rtol=0, atol=1e-6)
    assert t[0] > 1.4e9  # written back on the sequence's own epoch
    assert set(summary["ate"]) == {"se3", "posyaw"}
    if not staged:
        assert [k for k, _ in summary["result"]["dynamic_attempts"]] == [10]
