"""IMU intrinsics (calib_imu), the port's functions against the JAX
package's, in float64 on the CPU. (The calib_imu variant's 60 frames
against the JAX package's are in tests/test_torch_flags_prop.py, with
Schmidt states in tests/test_torch_flags_hybrid.py.)

* imu_intrinsics_to_vec / apply_imu_intrinsics_delta against the JAX
  functions (Ma's upper triangle untouched).
* The calib_imu slab transition (Phi_tot, Q_tot, S_tot, the propagated
  mean) and the covariance it gives, against JAX's imu_batch_transition
  and apply_leg_covariance under LARVIO and OrcVIO (left and right),
  from the fixture's start with intrinsics off the identity and a
  correlated P, carried into the port by convert.filter_state_from_numpy.
* The combined calib + Schmidt layout (intrinsic_base, nui_base,
  state_dim, the initial covariance) and increment_state's intrinsic
  delta against JAX's; a float32 calib_imu step stays float32
  (forward-mode AD promotes 0-d operands); a config.yaml with
  calib_imu_instrinsic: 1 through run_vio.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import augment as jaug
from orcvio_tpu.filter import hybrid as jh
from orcvio_tpu.filter import propagation as jprop
from orcvio_tpu.filter import state as jstate
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import augment as paug
from orcvio_tpu_torch.filter import hybrid as ph
from orcvio_tpu_torch.filter import pipeline as ppipe
from orcvio_tpu_torch.filter import propagation as pprop
from orcvio_tpu_torch.filter import state as pstate
from tests.test_torch_filter import port_frame

torch.set_num_threads(1)


def test_intrinsics_vec_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    Tg, As, Ma = (rng.normal(size=(3, 3)) for _ in range(3))
    Ma = np.tril(Ma)
    d = rng.normal(size=24) * 0.01
    theirs = jstate.apply_imu_intrinsics_delta(
        *map(jnp.asarray, (Tg, As, Ma, d)))
    ours = pstate.apply_imu_intrinsics_delta(
        *map(torch.as_tensor, (Tg, As, Ma, d)))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not np.triu(ours[2].numpy(), 1).any()
    v0, v1 = (pstate.imu_intrinsics_to_vec(*m) for m in (
        map(torch.as_tensor, (Tg, As, Ma)), ours))
    np.testing.assert_array_equal(
        v1.numpy(), np.asarray(jstate.imu_intrinsics_to_vec(*theirs)))
    np.testing.assert_allclose((v1 - v0).numpy(), d, rtol=0, atol=1e-15)


@pytest.fixture(scope="module")
def calib_states():
    """The fixture's initialized start in the calib_imu layout, with
    intrinsics off the identity and a correlated P, in both packages."""
    cfgd = fr.variant_cfg("calib_imu")
    js = fr.initial_state(JaxConfig(**cfgd))
    rng = np.random.default_rng(5)
    D = js.P.shape[0]
    A = rng.normal(size=(D, D)) * 0.01
    js = js.replace(P=jnp.asarray(np.diag(np.diag(np.asarray(js.P)))
                                  + A @ A.T),
                    Tg=jnp.asarray(np.eye(3) + 0.01 * rng.normal(size=(3, 3))),
                    As=jnp.asarray(0.01 * rng.normal(size=(3, 3))),
                    Ma=jnp.asarray(np.eye(3) + 0.01
                                   * np.tril(rng.normal(size=(3, 3)))))
    return cfgd, js, filter_state_from_numpy(state_to_numpy(js),
                                             torch.float64, "cpu")


FLAGS = {"larvio": dict(use_larvio=True),
         "orcvio_left": dict(use_larvio=False, use_left_perturbation=True),
         "orcvio_right": dict(use_larvio=False, use_left_perturbation=False)}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_slab_transition_matches_jax(calib_states, flags):
    """Frame 0's first 4 IMU samples (the last masked) from the state:
    the JAX package's imu_batch_transition (its per-sample scan) against
    the port's."""
    cfgd, js, ps = calib_states
    cfgd = {**cfgd, **FLAGS[flags]}
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    frames = fr.variant_frames("calib_imu")
    k, n = 0, 4
    slab = [np.array(x[k][:n]) for x in (frames.imu_t, frames.imu_gyro,
                                           frames.imu_acc, frames.imu_mask)]
    slab[3][-1] = False
    theirs = jax.jit(lambda s, *x: jprop.imu_batch_transition(jcfg, s, *x))(
        js, *map(jnp.asarray, slab))
    ours = pprop.imu_batch_transition(pcfg, ps, *map(torch.as_tensor, slab))
    st_j, st_p = theirs[0], ours[0]
    for name in ("R", "v", "p"):
        np.testing.assert_allclose(getattr(st_p.imu, name).numpy(),
                                   np.asarray(getattr(st_j.imu, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name, a, b in zip(("Phi", "Q", "S", "gyro", "acc"), ours[1:],
                          theirs[1:]):
        tol = 1e-11 * max(1.0, float(jnp.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol,
                                   err_msg=name)
    # the covariance through the intrinsic columns
    Pj = jprop.apply_leg_covariance(st_j, *theirs[1:4], jcfg.intrinsic_base).P
    Pp = pprop.apply_leg_covariance(st_p, *ours[1:4], pcfg.intrinsic_base).P
    np.testing.assert_allclose(Pp.numpy(), np.asarray(Pj), rtol=0, atol=1e-12)
    assert ours[3][:9].abs().max() > 0


def test_layout_and_increment_match_jax(calib_states):
    cfgd, js, ps = calib_states
    both = {**cfgd, **fr.VARIANTS["calib_schmidt"]}
    jcfg, pcfg = JaxConfig(**both), FilterConfig(**both)
    D = 22 + 6 * 8 + 6 + 24 + 6 * 6
    assert pcfg.state_dim == jcfg.state_dim == D
    assert pcfg.intrinsic_base == jcfg.intrinsic_base == 22 + 6 * 8 + 6
    assert ph.nui_base(pcfg) == jh.nui_base(jcfg) == pcfg.intrinsic_base + 24
    np.testing.assert_array_equal(pcfg.initial_cov_diag(),
                                  np.asarray(jcfg.initial_cov_diag()))
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    dx = np.random.default_rng(8).normal(size=pcfg.state_dim) * 1e-3
    theirs = jaug.increment_state(jcfg, js, jnp.asarray(dx))
    ours = paug.increment_state(pcfg, ps, torch.as_tensor(dx))
    for key in ("Tg", "As", "Ma"):
        np.testing.assert_allclose(getattr(ours, key).numpy(),
                                   np.asarray(getattr(theirs, key)), rtol=0,
                                   atol=1e-15, err_msg=key)
    assert not torch.equal(ours.Tg, ps.Tg)


def test_float32_calib_step_stays_float32(calib_states):
    cfgd, js, _ = calib_states
    cfg = FilterConfig(**cfgd)
    st = filter_state_from_numpy(state_to_numpy(js), torch.float32, "cpu")
    frames = fr.variant_frames("calib_imu")
    frame = ppipe.FrameInput(*(x.float() if x.is_floating_point() else x
                               for x in port_frame(frames, 0)))
    chi2 = ppipe.build_chi2_table(cfg, torch.float32, device="cpu")
    st2, out = ppipe.filter_step(cfg, st, frame, chi2)
    for x in (st2.P, st2.Tg, st2.As, st2.Ma, st2.imu.p, out.p):
        assert x.dtype == torch.float32
    assert bool(torch.isfinite(st2.P).all())


def test_run_vio_reads_and_runs_calib_imu_config(tmp_path, monkeypatch):
    """A config.yaml with calib_imu_instrinsic: 1 through the command
    (--staged, CPU) on the writer's bytes (320x240, a static start): the
    filter runs with the intrinsic states after static init."""
    from orcvio_tpu_torch import run_vio as prun
    from orcvio_tpu_torch.dataio import euroc_writer as pwriter
    from orcvio_tpu_torch.dataio import synthetic as psyn
    from orcvio_tpu_torch.eval import bench_setup as bs
    from orcvio_tpu_torch.eval import staged as pstaged

    n = 16
    sim = psyn.SimConfig(n_frames=n, **{**bs.BENCH_SIM, "static_time": 1.2})
    wc = pwriter.WriterConfig(cam=pwriter.CameraModel(
        width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0),
        tex_size=512)
    pwriter.write_euroc_dataset(str(tmp_path), sim, wc, device="cpu")
    pwriter.write_reference_config(
        str(tmp_path / "config.yaml"), sim, wc, max_features_num=48,
        min_distance=10, calib_imu_instrinsic=1, static_image_num=10)
    seen = []
    build = pstaged.make_e2e_replay

    def spy(cfg, *a, **kw):
        seen.append(cfg)
        return build(cfg, *a, **kw)

    monkeypatch.setattr(pstaged, "make_e2e_replay", spy)
    summary = prun.main(["--euroc", str(tmp_path), "--device", "cpu",
                         "--out", str(tmp_path / "traj.txt"), "--staged"])
    (cfg,) = seen
    assert cfg.calib_imu and cfg.state_dim == 172 + 24
    res = summary["result"]
    k0 = int(np.argmax(res["initialized"]))
    assert res["initialized"][k0] and k0 < n - 3, "static init, then filter"
    assert np.isfinite(res["p"]).all() and np.isfinite(res["R"]).all()
