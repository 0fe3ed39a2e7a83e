"""ZUPT's IMU chi-square test, the port's against the JAX package's.

The port solves the innovation covariance S of the IMU disturbance test
(``filter/zupt.py:zupt_imu_chi2``); the JAX package with
``jnp.linalg.solve`` (``orcvio_tpu/filter/zupt.py:104``). Over the first 40
frames of the filter parity fixture (tests/test_torch_filter.py: its
static start and the motion after it), the port's filter runs frame by
frame; at each of its ZUPT IMU checks, both
packages evaluate the check on the same state and IMU slab, in float64:
the statistic agrees within 1e-9 relative and the decision is identical.
The fixture's accelerometer noise fails every check, so each check is
also made on a still slab (the state's gravity plus a little noise in
place of the measured accelerations), which passes while the state is
slow: both decisions are taken.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import pipeline as jpipe
from orcvio_tpu.filter import zupt as jzupt
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import pipeline as ppipe
from orcvio_tpu_torch.filter import zupt as pzupt
from test_torch_filter import CFG, port_frame, sim_frames

torch.set_num_threads(1)

T = 40


@pytest.fixture(scope="module")
def checks():
    """Each ZUPT IMU check of the port's run: (state, slab, port decision)."""
    frames, st0 = sim_frames()
    cfg = FilterConfig(**CFG)
    chi2 = ppipe.build_chi2_table(cfg, torch.float64, device="cpu")
    ps = filter_state_from_numpy(state_to_numpy(st0), torch.float64, "cpu")
    seen = []

    def spy(cfg, state, imu_t, gyro, acc, mask, table, *a, **kw):
        ok = pzupt.check_zupt_imu(cfg, state, imu_t, gyro, acc, mask, table,
                                  *a, **kw)
        imu = state.imu
        seen.append((types.SimpleNamespace(
            P=state.P.clone(), imu=types.SimpleNamespace(
                R=imu.R.clone(), v=imu.v.clone(), ba=imu.ba.clone(),
                bg=imu.bg.clone())),
            (imu_t.clone(), gyro.clone(), acc.clone(), mask.clone()),
            bool(ok)))
        return ok

    mp = pytest.MonkeyPatch()
    mp.setattr(ppipe, "check_zupt_imu", spy)
    try:
        for k in range(T):
            ps, _ = ppipe.filter_step(cfg, ps, port_frame(frames, k), chi2)
    finally:
        mp.undo()
    return seen


def test_chi2_and_decisions_match_jax(checks, monkeypatch):
    jcfg, pcfg = JaxConfig(**CFG), FilterConfig(**CFG)
    jtable = jpipe.build_chi2_table(jcfg, jnp.float64)
    solves = []
    solve = jnp.linalg.solve

    def spy_solve(a, b):
        x = solve(a, b)
        solves.append(float(b @ x))
        return x

    monkeypatch.setattr(jnp.linalg, "solve", spy_solve)
    rng = np.random.default_rng(0)
    decisions = []
    for state, (imu_t, gyro, acc, mask), port_ok in checks:
        js = types.SimpleNamespace(
            P=jnp.asarray(state.P.numpy()), imu=types.SimpleNamespace(
                **{k: jnp.asarray(getattr(state.imu, k).numpy())
                   for k in ("R", "v", "ba", "bg")}))
        still = (state.imu.R.T @ torch.tensor([0.0, 0.0, pcfg.gravity],
                                              dtype=torch.float64)
                 + state.imu.ba + torch.as_tensor(
                     rng.normal(size=acc.shape) * 1e-4))
        for a, ok in ((acc, port_ok), (still, None)):
            jok = bool(jzupt.check_zupt_imu(
                jcfg, js, *(jnp.asarray(x.numpy()) for x in (imu_t, gyro, a,
                                                             mask)), jtable))
            if ok is None:
                ok = bool(pzupt.check_zupt_imu(pcfg, state, imu_t, gyro, a,
                                               mask, ppipe.build_chi2_table(
                                                   pcfg, torch.float64,
                                                   "cpu")))
            chi2, _ = pzupt.zupt_imu_chi2(pcfg, state, imu_t, a, mask)
            assert jok == ok
            assert abs(float(chi2) - solves[-1]) <= 1e-9 * abs(solves[-1])
            decisions.append(jok)
    assert len(decisions) >= 2 * (T - 1)
    assert any(decisions) and not all(decisions)
