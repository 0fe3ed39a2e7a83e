"""The perturbation-convention variants of the filter, the port's against
the JAX package's, in float64 on the CPU.

* 60 frames of filter_step (tests/flag_runs.py) under ``left_perturb``
  (LARVIO with the left perturbation: ZUPT's IMU test takes its left
  branch), ``fej`` (first-estimate Jacobians) and ``extrinsic_td`` (the
  extrinsic and td states estimated): p, R, v per frame within 1e-8,
  identical decisions, and the branch fired in both packages (ZUPT
  decided; first estimates apart from the estimates; the extrinsics and td
  moved).
* On the variants' last states: get_cam_wrt_imu_se3_jacobian (both
  conventions), the non-LARVIO measurement Jacobians (left and right, with
  and without FEJ, with the td column), the right-convention increment,
  and ZUPT's left IMU chi-square statistic and decision, each against the
  JAX function on the same inputs.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import augment as jaug
from orcvio_tpu.filter import pipeline as jpipe
from orcvio_tpu.filter import tracks as jtracks
from orcvio_tpu.filter import update as jupd
from orcvio_tpu.filter import zupt as jzupt
from orcvio_tpu.math import se3 as jse3
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import augment as paug
from orcvio_tpu_torch.filter import pipeline as ppipe
from orcvio_tpu_torch.filter import tracks as ptracks
from orcvio_tpu_torch.filter import update as pupd
from orcvio_tpu_torch.filter import zupt as pzupt
from orcvio_tpu_torch.math import se3 as pse3

torch.set_num_threads(1)

NAMES = ["left_perturb", "fej", "extrinsic_td"]


@pytest.fixture(scope="module", autouse=True)
def _compiled():
    fr.compile_jax(NAMES)


@pytest.mark.parametrize("field", ["p", "R", "v"])
@pytest.mark.parametrize("name", NAMES)
def test_pose_matches_per_frame(name, field):
    fr.check_pose(name, field)


@pytest.mark.parametrize("name", NAMES)
def test_decisions_identical(name):
    fr.check_decisions(name)


@pytest.mark.parametrize("name", NAMES)
def test_branch_fired(name):
    r = fr.run(name)
    for pkg in ("jax", "port"):
        out, final = r[pkg]["out"], r[pkg]["final"]
        assert out.n_update_features.sum() > 0
        if name == "left_perturb":
            assert out.zupt.sum() > 0
        elif name == "fej":  # the first estimates the Jacobians read
            valid = final["clones"]["valid"]
            gap = np.abs(final["clones"]["p_fej"] - final["clones"]["p"])[valid]
            assert gap.max() > 1e-6
        else:  # the extrinsic and td states moved
            st0 = fr.state_to_numpy(fr.initial_state(
                JaxConfig(**fr.variant_cfg(name))))
            for key in ("R_b2c", "t_c_b", "td"):
                assert np.abs(final[key] - st0[key]).max() > 1e-9, key


def t(x):
    return torch.as_tensor(np.array(x))


def states(name):
    """The variant's last state in both packages' types (the port's run's)."""
    cfgd = fr.variant_cfg(name)
    d = fr.run(name)["port"]["final"]
    jst = fr.jax_state_like(fr.initial_state(JaxConfig(**cfgd)), d)
    return cfgd, jst, filter_state_from_numpy(d, torch.float64, "cpu")


@pytest.mark.parametrize("left", [True, False])
def test_cam_wrt_imu_jacobian_matches_jax(left):
    rng = np.random.default_rng(5)
    R = np.linalg.qr(rng.normal(size=(2, 4, 3, 3)))[0]
    args = (R[0, 0], rng.normal(size=3), R[1], rng.normal(size=(4, 3)))
    theirs = jse3.get_cam_wrt_imu_se3_jacobian(*map(jnp.asarray, args), left)
    ours = pse3.get_cam_wrt_imu_se3_jacobian(*map(t, args), left)
    assert ours.shape == (4, 6, 6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("flags", [
    dict(use_larvio=False, use_left_perturbation=True),
    dict(use_larvio=False, use_left_perturbation=False),
    dict(use_larvio=False, use_left_perturbation=True, if_fej=True,
         estimate_td=True),
    dict(use_larvio=True, if_fej=True, estimate_td=True)],
    ids=["left", "right", "left_fej_td", "larvio_fej_td"])
def test_feature_jacobians_match_jax(flags):
    cfgd, jst, pst = states("fej")
    cfgd = {**cfgd, **flags}
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    ct_j = jtracks.compact_tracks(jst.features, jst.clones.order, 6)
    ct_p = ptracks.compact_tracks(pst.features, pst.clones.order, 6)
    rng = np.random.default_rng(6)
    F = pst.features.fid.shape[0]
    # points 4-6 m ahead of the newest clone's camera (its z axis is the
    # body's x axis), with a velocity on every observation for td
    c = int(pst.clones.order.argmax())
    ahead = pst.clones.R[c, :, 0].numpy() * rng.uniform(4, 6, size=(F, 1))
    p_w = pst.clones.p[c].numpy() + ahead + rng.normal(size=(F, 3)) * 0.5
    vel = rng.normal(size=ct_p.uv_vel.shape) * 0.1
    ct_j = ct_j._replace(uv_vel=jnp.asarray(vel))
    ct_p = ct_p._replace(uv_vel=t(vel))
    theirs = jupd.feature_jacobians(jcfg, jst, ct_j, jnp.asarray(p_w))
    ours = pupd.feature_jacobians(pcfg, pst, ct_p, t(p_w))
    assert bool(ct_p.mask.any())
    for name in ("H_raw", "r_raw", "Hf_raw", "H", "r"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * max(
            1.0, np.abs(b).max()), err_msg=name)


def test_right_increment_matches_jax():
    cfgd, jst, pst = states("extrinsic_td")
    cfgd = {**cfgd, "use_larvio": False, "use_left_perturbation": False}
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    dx = np.random.default_rng(7).normal(size=pst.P.shape[0]) * 0.01
    theirs = fr.state_to_numpy(jaug.increment_state(jcfg, jst,
                                                   jnp.asarray(dx)))
    ours = state_to_numpy(paug.increment_state(pcfg, pst, t(dx)))
    for key in ("imu", "clones", "features"):
        for f, v in theirs[key].items():
            np.testing.assert_allclose(ours[key][f], v, rtol=0, atol=1e-14,
                                       err_msg=f"{key}.{f}")
    for key in ("R_b2c", "t_c_b", "td"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-14)


def test_zupt_left_chi2_matches_jax(monkeypatch):
    """The left branch of the IMU test's H (orcvio_tpu/filter/zupt.py:79-82)
    on the left_perturb run's last state, on the fixture's slabs of frames
    0-19 (its static start) and on still slabs: statistic within 1e-9
    relative, decisions identical, both decisions taken."""
    cfgd, jst, pst = states("left_perturb")
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    assert jcfg.use_left_perturbation
    jtable = jpipe.build_chi2_table(jcfg, jnp.float64)
    ptable = ppipe.build_chi2_table(pcfg, torch.float64, "cpu")
    solves = []
    solve = jnp.linalg.solve

    def spy_solve(a, b):
        x = solve(a, b)
        solves.append(float(b @ x))
        return x

    monkeypatch.setattr(jnp.linalg, "solve", spy_solve)
    frames = fr.sim_frames()[0]
    rng = np.random.default_rng(8)
    # a slow state, so that a still slab passes the velocity test too
    js = types.SimpleNamespace(P=jst.P, imu=jst.imu.replace(v=jst.imu.v * 0.0))
    ps = pst.replace(imu=pst.imu.replace(v=pst.imu.v * 0.0))
    decisions = []
    for k in range(20):
        imu_t, gyro, acc, mask = (np.asarray(frames[i][k]) for i in (1, 2, 3, 4))
        still = (ps.imu.R.T.numpy() @ np.asarray([0.0, 0.0, pcfg.gravity])
                 + ps.imu.ba.numpy() + rng.normal(size=acc.shape) * 1e-4)
        for a in (acc, still):
            jok = bool(jzupt.check_zupt_imu(
                jcfg, js, *(jnp.asarray(x) for x in (imu_t, gyro, a, mask)),
                jtable))
            pok = bool(pzupt.check_zupt_imu(pcfg, ps, t(imu_t), t(gyro), t(a),
                                            t(mask), ptable))
            chi2, _ = pzupt.zupt_imu_chi2(pcfg, ps, t(imu_t), t(a), t(mask))
            assert jok == pok
            assert abs(float(chi2) - solves[-1]) <= 1e-9 * abs(solves[-1])
            decisions.append(jok)
    assert any(decisions) and not all(decisions)


def test_left_and_right_zupt_statistics_differ():
    """The left branch is not the right one: on a rotated state the two
    statistics differ."""
    cfgd, _, pst = states("left_perturb")
    frames = fr.sim_frames()[0]
    imu_t, acc, mask = (t(frames[i][25]) for i in (1, 3, 4))
    chi = [float(pzupt.zupt_imu_chi2(FilterConfig(**{
        **cfgd, "use_left_perturbation": left}), pst, imu_t, acc, mask)[0])
        for left in (True, False)]
    assert abs(chi[0] - chi[1]) > 1e-6 * abs(chi[0])
