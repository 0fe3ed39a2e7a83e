"""The JAX package's public helpers that the filter's slab path does not
call: the port (orcvio_tpu_torch/filter/propagation.py,
math/quat.py) against the JAX package on the CPU, float64, within 1e-12.

* quat.from_small_angle on rotation vectors below and above the branch
  |dtheta / 2| = 1 (tests/test_math.py's small-angle case among them).
* propagation.propagate_mean_rk4 on tests/test_propagation.py's cases:
  zero gyro at dt = 0.5, a random state at dt = 0.002, a large rotation.
* propagation.process_step, one sample at a time over 30 samples, under
  the flags of test_propagation.py's covariance test, with FEJ and with
  the IMU intrinsics; and at t_imu == state.t an exact no-op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import propagation as jprop
from orcvio_tpu.filter.state import FilterState as JaxState
from orcvio_tpu.filter.state import ImuState as JaxImu
from orcvio_tpu.math import quat as jquat
from orcvio_tpu.math import so3 as jso3
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import propagation as pprop
from orcvio_tpu_torch.filter.state import ImuState
from orcvio_tpu_torch.math import quat as pquat

TOL = 1e-12
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("scale", [1e-4, 0.3, 1.5, 4.0])
def test_from_small_angle(scale):
    rng = np.random.default_rng(int(scale * 1e4))
    d = rng.normal(size=(16, 3)) * scale
    want = np.asarray(jquat.from_small_angle(jnp.asarray(d)))
    got = pquat.from_small_angle(_t(d))
    assert got.dtype == F64 and got.shape == (16, 4)
    _close(want, got, "from_small_angle")
    if scale == 1e-4:  # tests/test_math.py:107
        R = pquat.to_rotation(got).numpy()
        np.testing.assert_allclose(R, np.asarray(jso3.exp(jnp.asarray(d))),
                                   atol=1e-8)


def _rand_imu(rng):
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.5)))
    return dict(R=R, v=rng.normal(size=3), p=rng.normal(size=3) * 2,
                bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05)


RK4_CASES = {
    "zero_gyro": (None, [0.0, 0.0, 0.0], [1.0, 0.0, 9.81], 0.5),
    "small_dt": ("rand", [0.3, -0.2, 0.5], [1.0, 2.0, 9.0], 0.002),
    "large_rotation": ("rand", [2.0, -1.0, 3.0], [0.5, -0.3, 9.7], 0.05),
}


@pytest.mark.parametrize("case", sorted(RK4_CASES))
def test_propagate_mean_rk4(case):
    init, gyro, acc, dt = RK4_CASES[case]
    rng = np.random.default_rng(42)
    imu = (_rand_imu(rng) if init else
           {k: np.eye(3) if k == "R" else np.zeros(3)
            for k in ("R", "v", "p", "bg", "ba")})
    g_w = np.array([0.0, 0.0, -9.81])
    want = jprop.propagate_mean_rk4(
        JaxImu(**{k: jnp.asarray(v) for k, v in imu.items()}),
        jnp.asarray(gyro), jnp.asarray(acc), dt, jnp.asarray(g_w))
    got = pprop.propagate_mean_rk4(
        ImuState(**{k: _t(v) for k, v in imu.items()}), _t(gyro), _t(acc),
        dt, _t(g_w))
    for f in ("R", "v", "p", "bg", "ba"):
        assert getattr(got, f).dtype == F64
        _close(getattr(want, f), getattr(got, f), f"{case}.{f}")


STEP_FLAGS = {
    "orcvio_euler_left": dict(use_larvio=False, use_left_perturbation=True,
                              use_closed_form_cov_prop=False),
    "orcvio_closed_right": dict(use_larvio=False,
                                use_left_perturbation=False,
                                use_closed_form_cov_prop=True),
    "larvio": dict(use_larvio=True, use_left_perturbation=True,
                   use_closed_form_cov_prop=True),
    "larvio_fej": dict(use_larvio=True, use_left_perturbation=True,
                       use_closed_form_cov_prop=True, if_fej=True),
    "calib_imu": dict(use_larvio=True, use_left_perturbation=True,
                      use_closed_form_cov_prop=True, calib_imu=True),
}


def _start(kw, rng):
    """The JAX state of test_propagation.py's make_state (a random IMU,
    FEJ apart from it) and the port's copy."""
    jcfg = JaxConfig(sw_size=4, max_features=8, **kw)
    st = JaxState.create(jcfg, dtype=jnp.float64)
    imu = JaxImu(**{k: jnp.asarray(v) for k, v in _rand_imu(rng).items()})
    fej = imu.replace(v=imu.v + 0.01, p=imu.p + 0.02)
    st = st.replace(imu=imu, imu_old=imu, imu_fej_now=fej, imu_fej_old=fej,
                    t=jnp.asarray(0.0, jnp.float64))
    if kw.get("calib_imu"):
        st = st.replace(Tg=st.Tg + 0.01 * jnp.asarray(rng.normal(size=(3, 3))),
                        As=0.001 * jnp.asarray(rng.normal(size=(3, 3))),
                        Ma=st.Ma + 0.01 * jnp.asarray(
                            rng.normal(size=(3, 3))))
    return (jcfg, st, FilterConfig(sw_size=4, max_features=8, **kw),
            filter_state_from_numpy(state_to_numpy(st), F64, "cpu"))


@pytest.mark.parametrize("name", sorted(STEP_FLAGS))
def test_process_step(name):
    rng = np.random.default_rng(7)
    jcfg, js, pcfg, ps = _start(STEP_FLAGS[name], rng)
    jstep = jax.jit(lambda s, *a: jprop.process_step(jcfg, s, *a))
    g_old, a_old = np.zeros(3), np.array([0.0, 0.0, 9.81])
    t = 0.0
    for _ in range(30):
        t += 0.005
        gyro = rng.normal(size=3) * 0.2
        acc = np.array([0.0, 0.0, 9.81]) + rng.normal(size=3) * 0.3
        js = jstep(js, t, *(jnp.asarray(x) for x in (gyro, acc, g_old,
                                                     a_old)))
        ps = pprop.process_step(pcfg, ps, t, _t(gyro), _t(acc), _t(g_old),
                                _t(a_old))
        g_old, a_old = gyro, acc
    want, got = state_to_numpy(js), state_to_numpy(ps)
    assert got["P"].dtype == np.float64
    for f in ("t", "P", "last_gyro", "last_acc"):
        _close(want[f], got[f], f"{name}.{f}")
    for part in ("imu", "imu_old", "imu_fej_now", "imu_fej_old"):
        for f, v in want[part].items():
            _close(v, got[part][f], f"{name}.{part}.{f}")
    # a sample at the state's own time changes nothing
    same = pprop.process_step(pcfg, ps, t, _t(gyro), _t(acc), _t(g_old),
                              _t(a_old))
    assert torch.equal(same.P, ps.P) and torch.equal(same.imu.p, ps.imu.p)
    assert dataclasses.is_dataclass(same)
