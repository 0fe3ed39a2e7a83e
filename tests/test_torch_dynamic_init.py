"""The port's dynamic initializer and preintegration against the JAX
package's, in float64 on the CPU.

The window is tests/test_dynamic_init.py's (10 frames at 10 Hz of the
synthetic world, a non-symmetric camera extrinsic, low noise). The window
SfM's RANSAC draw is the JAX package's, injected as Gumbel noise (the
Gumbel-max form of its jax.random.categorical draw). SVD factors may
differ in sign between the packages, so what the functions return is
compared, not the factors. Each function is held to JAX's within 1e-9
(the pose-refining ones within 1e-8), and dynamic_initialize and
flexible_dynamic_attempt give the same ok with R, v and bg within 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.dataio.synthetic import SimConfig, generate
from orcvio_tpu.filter.pipeline import FrameInput as JaxFrame
from orcvio_tpu.init import dynamic as jdyn
from orcvio_tpu.init import preintegration as jpre
from orcvio_tpu.math import se3 as jse3
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.filter.pipeline import FrameInput
from orcvio_tpu_torch.init import dynamic as pdyn
from orcvio_tpu_torch.init import preintegration as ppre
from orcvio_tpu_torch.math import se3 as pse3

torch.set_num_threads(1)

TOL = 1e-9
POSE_TOL = 1e-8
K = 10
SIM = SimConfig(n_frames=K, frame_hz=10.0, imu_slab=24, n_landmarks=250,
                max_obs=60, uv_noise=5e-4, gyro_noise=1e-4, acc_noise=1e-3,
                seed=7, radius=2.0, omega=0.8)
R_B2C = np.asarray([[0.0, -1, 0], [0, 0, -1], [1.0, 0, 0]])
T_C_B = np.asarray([0.04, 0.01, 0.02])


def T(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def gumbel(key, n):
    """JAX's window-SfM RANSAC noise for key and n track rows."""
    return T(jax.random.gumbel(key, (256, 8, n), jnp.float64))


@pytest.fixture(scope="module")
def window():
    data = generate(SIM, R_b2c=jnp.asarray(R_B2C), t_c_b=jnp.asarray(T_C_B))
    f = jax.tree.map(np.asarray, data.frames)
    uv, m = pdyn.build_tracks(f.fids, f.uvs, f.meas_mask)
    return f, uv, m


def test_build_tracks_matches_jax(window):
    f, uv, m = window
    juv, jm = jdyn.build_tracks(f.fids, f.uvs, f.meas_mask)
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_array_equal(m, jm)
    assert m.sum(1).min() >= 2 and uv.shape == (80, K, 2)


@pytest.mark.parametrize("bias", [False, True])
def test_preintegrate_sequence_matches_jax(window, bias):
    f = window[0]
    rng = np.random.default_rng(1)
    bg, ba = (rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.1) \
        if bias else (None, None)
    mask = f.imu_mask.copy()
    mask[3, 4:] = False  # a short slab
    j = jax.jit(jpre.preintegrate_sequence)(
        *map(jnp.asarray, (f.imu_t, f.imu_gyro, f.imu_acc, mask)),
        None if bg is None else jnp.asarray(bg),
        None if ba is None else jnp.asarray(ba))
    p = ppre.preintegrate_sequence(
        *map(T, (f.imu_t, f.imu_gyro, f.imu_acc, mask)),
        None if bg is None else T(bg), None if ba is None else T(ba))
    for name in j._fields:
        close(getattr(p, name), getattr(j, name))


def test_preintegrate_one_gap_matches_jax(window):
    f = window[0]
    args = (f.imu_t[2], f.imu_gyro[2], f.imu_acc[2], f.imu_mask[2],
            np.full(3, 0.003), np.full(3, -0.02))
    j = jpre.preintegrate(*map(jnp.asarray, args))
    p = ppre.preintegrate(*map(T, args))
    for name in j._fields:
        close(getattr(p, name), getattr(j, name))


def test_se3_exp_and_inverse_match_jax():
    xi = np.random.default_rng(2).normal(size=(5, 6))
    xi[0, 3:] = 0.0  # the small-angle branch
    close(pse3.exp(T(xi)), jse3.exp(jnp.asarray(xi)), 1e-14)
    Tw = np.asarray(jse3.exp(jnp.asarray(xi)))
    close(pse3.inverse_pose(T(Tw)), jse3.inverse_pose(jnp.asarray(Tw)),
          1e-14)


def test_decompose_essential_matches_jax(window):
    _, uv, m = window
    both = m[:, 0] & m[:, K - 1]
    p1, p2 = uv[:, 0], uv[:, K - 1]
    _, E = jax.jit(jdyn.ransac_fundamental, static_argnames="n_hyp")(
        *map(jnp.asarray, (p1, p2, both)), jax.random.PRNGKey(0), n_hyp=256)
    j = jdyn.decompose_essential(E, *map(jnp.asarray, (p1, p2, both)))
    p = pdyn.decompose_essential(T(E), *map(T, (p1, p2, both)))
    close(p[0], j[0])
    close(p[1], j[1])
    assert int(p[2]) == int(j[2]) > 12


def test_triangulate_dlt_matches_jax(window):
    _, uv, m = window
    cTw = np.asarray(jse3.exp(jnp.asarray(
        np.random.default_rng(3).normal(size=(K, 6)) * 0.05)))
    m = m.copy()
    m[:3, 1:] = False  # rows with one observation: not ok
    jp, jok = jdyn.triangulate_dlt(*map(jnp.asarray, (cTw, uv, m)))
    pp, pok = pdyn.triangulate_dlt(*map(T, (cTw, uv, m)))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert not pok[:3].any() and pok.sum() > 50
    ok = pok.numpy()
    close(pp.numpy()[ok], np.asarray(jp)[ok], 1e-8)


@pytest.fixture(scope="module")
def sfm(window):
    """Both packages' window SfM on the window, JAX's draws injected."""
    _, uv, m = window
    key = jax.random.PRNGKey(0)
    j = jax.jit(jdyn.window_sfm)(jnp.asarray(uv), jnp.asarray(m), key)
    p = pdyn.window_sfm(T(uv), T(m), gumbel=gumbel(key, uv.shape[0]))
    return j, p


def test_window_sfm_matches_jax(sfm):
    (js, jp, jok), (ps, pp, pok) = sfm
    assert bool(ps.ok) == bool(js.ok) is True
    close(ps.R_c0_ck, js.R_c0_ck, POSE_TOL)
    close(ps.p_c0_ck, js.p_c0_ck, POSE_TOL)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    ok = pok.numpy()
    close(pp.numpy()[ok], np.asarray(jp)[ok], POSE_TOL)


def test_pnp_gn_batched_matches_jax_per_frame(window, sfm):
    _, uv, m = window
    _, (ps, pw, ok3d) = sfm
    wTc = pse3.make_pose(ps.R_c0_ck, ps.p_c0_ck)
    cTw0 = pse3.inverse_pose(wTc).numpy()
    cTw0[:, :3, 3] += 0.01  # a perturbed start
    mask = m.T & ok3d.numpy()[None, :]
    got, cost = pdyn.pnp_gn(pw, T(uv).transpose(0, 1), T(mask), T(cTw0))
    for k in (0, 4, K - 1):
        want, wcost = jdyn.pnp_gn(jnp.asarray(pw.numpy()),
                                  jnp.asarray(uv[:, k]), jnp.asarray(mask[k]),
                                  jnp.asarray(cTw0[k]))
        close(got[k], want, POSE_TOL)
        assert abs(float(cost[k]) - float(wcost)) <= 1e-12


def test_bundle_adjust_matches_jax(window, sfm):
    _, uv, m = window
    _, (ps, pw, ok3d) = sfm
    cTw = pse3.inverse_pose(pse3.make_pose(ps.R_c0_ck, ps.p_c0_ck)).numpy()
    pw0 = pw.numpy() + 0.01
    mask = m & ok3d.numpy()[:, None]
    jc, jpw, jcost = jax.jit(jdyn.bundle_adjust, static_argnums=(4, 5))(
        *map(jnp.asarray, (cTw, pw0, uv, mask)), 0, 4)
    pc, ppw, pcost = pdyn.bundle_adjust(*map(T, (cTw, pw0, uv, mask)),
                                        fixed_frame=0, iters=4)
    close(pc, jc, POSE_TOL)
    ok = ok3d.numpy()
    close(ppw.numpy()[ok], np.asarray(jpw)[ok], POSE_TOL)
    close(pcost, jcost, 1e-12)


def test_alignment_solves_match_jax(window, sfm):
    f, _, _ = window
    (js, _, _), _ = sfm
    R_c0_bk = np.einsum("kij,jl->kil", np.asarray(js.R_c0_ck), R_B2C)
    gap = f.imu_mask.sum(1) > 0
    pre = jax.jit(jpre.preintegrate_sequence)(
        *map(jnp.asarray, (f.imu_t, f.imu_gyro, f.imu_acc, f.imu_mask)))
    ppre_ = ppre.preintegrate_sequence(
        *map(T, (f.imu_t, f.imu_gyro, f.imu_acc, f.imu_mask)))
    close(pdyn.solve_gyro_bias(ppre_, T(R_c0_bk), T(gap)),
          jdyn.solve_gyro_bias(pre, jnp.asarray(R_c0_bk), jnp.asarray(gap)))
    j = jax.jit(jdyn.linear_alignment)(pre, jnp.asarray(R_c0_bk),
                              jnp.asarray(js.p_c0_ck), jnp.asarray(T_C_B),
                              pre.dt, jnp.asarray(gap))
    p = pdyn.linear_alignment(ppre_, T(R_c0_bk), T(np.asarray(js.p_c0_ck)),
                              T(T_C_B), ppre_.dt, T(gap))
    for a, b in zip(p[:3], j[:3]):
        close(a, b, POSE_TOL)
    assert bool(p[3]) == bool(j[3])


def _assert_results_match(p, j):
    assert bool(p.ok) == bool(j.ok) is True
    for name in ("R", "v", "bg"):
        close(getattr(p.imu, name), getattr(j.imu, name), POSE_TOL)
    close(p.imu.p, j.imu.p, 0)
    assert abs(float(p.scale) - float(j.scale)) < POSE_TOL


def test_dynamic_initialize_matches_jax(window):
    f, uv, m = window
    key = jax.random.PRNGKey(1)
    imu = (f.imu_t, f.imu_gyro, f.imu_acc, f.imu_mask)
    j = jax.jit(jdyn.dynamic_initialize, static_argnums=0)(
        JaxConfig(), *map(jnp.asarray, (uv, m, *imu, R_B2C, T_C_B)), key)
    p = pdyn.dynamic_initialize(FilterConfig(), *map(T, (uv, m, *imu, R_B2C,
                                                         T_C_B)),
                                gumbel=gumbel(key, uv.shape[0]))
    _assert_results_match(p, j)


def test_flexible_dynamic_attempt_matches_jax(window, monkeypatch):
    f, uv, _ = window
    jframes = [JaxFrame(*(jnp.asarray(x[k]) for x in f)) for k in range(K)]
    pframes = [FrameInput(*(T(x[k]) for x in f)) for k in range(K)]
    key = jax.random.PRNGKey(2)
    monkeypatch.setattr(jdyn, "dynamic_initialize", jax.jit(
        jdyn.dynamic_initialize, static_argnums=0))
    j = jdyn.flexible_dynamic_attempt(JaxConfig(), jframes, R_B2C, T_C_B, key)
    p = pdyn.flexible_dynamic_attempt(FilterConfig(), pframes, R_B2C, T_C_B,
                                      gumbel=gumbel(key, uv.shape[0]))
    _assert_results_match(p, j)
    # too few tracks: no attempt, in both
    assert jdyn.flexible_dynamic_attempt(JaxConfig(), jframes[:2], R_B2C,
                                         T_C_B, key, min_tracks=500) is None
    assert pdyn.flexible_dynamic_attempt(FilterConfig(), pframes[:2], R_B2C,
                                         T_C_B, min_tracks=500) is None


def test_a_window_without_parallax_fails_in_both(window):
    """Every frame sees the first frame's tracks: the SfM is degenerate
    (NaN poses); neither package raises, both return ok = False."""
    f, uv, m = window
    uv = np.repeat(uv[:, :1], K, axis=1)
    m = np.repeat(m[:, :1], K, axis=1)
    key = jax.random.PRNGKey(1)
    imu = (f.imu_t, f.imu_gyro, f.imu_acc, f.imu_mask)
    j = jax.jit(jdyn.dynamic_initialize, static_argnums=0)(
        JaxConfig(), *map(jnp.asarray, (uv, m, *imu, R_B2C, T_C_B)), key)
    p = pdyn.dynamic_initialize(FilterConfig(), *map(T, (uv, m, *imu, R_B2C,
                                                         T_C_B)),
                                gumbel=gumbel(key, uv.shape[0]))
    assert bool(j.ok) is False and bool(p.ok) is False
