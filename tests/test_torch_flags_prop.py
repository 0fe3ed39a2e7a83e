"""The OrcVIO propagation variants of the filter, the port's against the
JAX package's, in float64 on the CPU.

* 60 frames of filter_step (tests/flag_runs.py) under ``orcvio_prop``
  (closed-form SE(3) mean, closed-form left Phi), ``orcvio_right`` (the
  right-perturbation closed-form Phi, noise matrix, increment and
  Jacobians), ``orcvio_euler`` (the first-order Phi of the JAX package's
  FilterConfig() defaults) and ``calib_imu`` (the IMU intrinsics, its
  IMU slab cut to 12 samples): p, R, v per
  frame within 1e-8 (5e-8 for orcvio_prop and orcvio_euler, whose runs
  amplify rounding: see flag_runs.TOLS), identical decisions, and each
  variant's transition function reached in both packages; under
  calib_imu the intrinsics move off the identity, to the JAX package's
  within 1e-9, with the final P.
* The propagation functions on seeded random slabs: propagate_mean_closed_form,
  phi_euler (both conventions), phi_closed_form_right and the right noise
  matrix, each against the JAX function under jax.vmap, within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.filter import propagation as jprop
from orcvio_tpu.filter.state import ImuState as JaxImu
from orcvio_tpu_torch.filter import propagation as pprop
from orcvio_tpu_torch.filter.state import ImuState

torch.set_num_threads(1)

NAMES = ["orcvio_prop", "orcvio_right", "orcvio_euler", "calib_imu"]
BRANCH = {"orcvio_prop": "phi_closed_form_left",
          "orcvio_right": "phi_closed_form_right",
          "orcvio_euler": "phi_euler",
          "calib_imu": "_bias_intrinsic_sensitivity"}


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
    fn = BRANCH[name]
    assert r["jax"]["spies"][fn] >= 1, "traced into the JAX step"
    assert r["port"]["spies"][fn] == fr.T, "once a frame in the port"
    for pkg in ("jax", "port"):
        assert r[pkg]["out"].n_update_features.sum() > 0
        assert r[pkg]["out"].zupt.sum() > 0


def test_calib_intrinsics_match_jax():
    """The fixture's IMU has identity intrinsics; calib_imu moves them
    (ROADMAP section 3 item 19) alike in both packages."""
    r = fr.run("calib_imu")
    for pkg in ("jax", "port"):
        f = r[pkg]["final"]
        assert f["P"].shape == (22 + 6 * 8 + 6 + 24,) * 2
        assert np.abs(f["Tg"] - np.eye(3)).max() > 1e-5
        assert np.abs(f["As"]).max() > 1e-5
        assert np.abs(f["Ma"] - np.eye(3)).max() > 1e-5
        assert not np.triu(f["Ma"], 1).any(), "Ma stays lower triangular"
    for key in ("Tg", "As", "Ma", "P"):
        np.testing.assert_allclose(r["port"]["final"][key],
                                   r["jax"]["final"][key], rtol=0, atol=1e-9,
                                   err_msg=key)


def _slab(seed, S=16):
    rng = np.random.default_rng(seed)
    R = jax.vmap(jprop.so3.exp)(jnp.asarray(rng.normal(size=(S, 3))))
    return dict(R=np.asarray(R), gyro=rng.normal(size=(S, 3)),
                acc=rng.normal(size=(S, 3)) * 3.0,
                dt=rng.uniform(0.0, 0.01, size=S),
                v=rng.normal(size=(S, 3)), p=rng.normal(size=(S, 3)))


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("left", [True, False])
def test_phi_euler_matches_jax(left):
    s = _slab(1)
    theirs = jax.vmap(jprop.phi_euler, in_axes=(0, 0, 0, 0, None))(
        s["R"], s["gyro"], s["acc"], s["dt"], left)
    ours = pprop.phi_euler(t(s["R"]), t(s["gyro"]), t(s["acc"]), t(s["dt"]),
                           left)
    _close(ours, theirs)


def test_phi_closed_form_right_matches_jax():
    s = _slab(2)
    theirs = jax.vmap(jprop.phi_closed_form_right)(s["R"], s["dt"], s["gyro"],
                                                    s["acc"])
    ours = pprop.phi_closed_form_right(t(s["R"]), t(s["dt"]), t(s["gyro"]),
                                       t(s["acc"]))
    _close(ours, theirs)


@pytest.mark.parametrize("left", [True, False])
def test_noise_input_matrix_matches_jax(left):
    s = _slab(3)
    theirs = jax.vmap(jprop.noise_input_matrix, in_axes=(0, None, None))(
        s["R"], left, jnp.float64)
    _close(pprop.noise_input_matrix(t(s["R"]), left), theirs, 0.0)


def test_propagate_mean_closed_form_matches_jax():
    s = _slab(4)
    z = np.zeros_like(s["v"])
    g = np.asarray([0.0, 0.0, -9.81])

    def jax_one(R, v, p, gyro, acc, dt):
        imu = JaxImu(R=R, v=v, p=p, bg=jnp.zeros(3), ba=jnp.zeros(3))
        out = jprop.propagate_mean_closed_form(imu, gyro, acc, dt,
                                               jnp.asarray(g))
        return out.R, out.v, out.p

    theirs = jax.vmap(jax_one)(s["R"], s["v"], s["p"], s["gyro"], s["acc"],
                               s["dt"])
    imu = ImuState(R=t(s["R"]), v=t(s["v"]), p=t(s["p"]), bg=t(z), ba=t(z))
    ours = pprop.propagate_mean_closed_form(imu, t(s["gyro"]), t(s["acc"]),
                                            t(s["dt"]), t(g))
    for a, b in zip((ours.R, ours.v, ours.p), theirs):
        _close(a, b)
