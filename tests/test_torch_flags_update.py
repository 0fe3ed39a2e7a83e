"""The update-form variants of the filter, the port's against the JAX
package's, in float64 on the CPU.

* 60 frames of filter_step (tests/flag_runs.py) under ``update_qr``
  (thin-QR compression), ``update_chol`` (Gram-Cholesky compression),
  ``update_information`` (the information form) and ``joseph`` (the Joseph
  covariance form): p, R, v per frame within 1e-8 (1e-6 for the
  information form, whose LU amplifies rounding: flag_runs.TOLS),
  identical decisions, and the branch fired in both packages (the form's
  function reached, updates made; K4 not called where the form has no
  (I - K H) P step).
* ``update_chol`` gives NaN in both packages from the fixture's first
  ZUPT on (frame 1): ZUPT's 9 rows touch 15 columns, so H^T H is rank
  deficient beyond its zero columns and its Cholesky fails, which
  chol_compress turns into NaN. The test holds the NaN to the same frames
  in both packages; without ZUPT the NaN comes with the first visual
  update, on the same frame in both.
* qr_compress, chol_compress, masked_psd_solve and information_update
  against the JAX functions on the same inputs, with the Gram invariants
  the update reads (R^T R = H^T H, R^T r_c = H^T r).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import update as jupd
from orcvio_tpu.math import linalg as jlinalg
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import update as pupd
from orcvio_tpu_torch.math import linalg as plinalg

torch.set_num_threads(1)

NAMES = ["update_qr", "update_chol", "update_information", "joseph"]


@pytest.fixture(scope="module", autouse=True)
def _compiled():
    fr.compile_jax(NAMES + ["update_chol_no_zupt"])


BRANCH = {"update_qr": "qr_compress", "update_chol": "chol_compress",
          "update_information": "information_update"}


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
    if name in BRANCH:
        fn = BRANCH[name]
        assert r["jax"]["spies"][fn] >= 1, "traced into the JAX step"
        # the stacked, ZUPT and last-chance updates of every frame
        assert r["port"]["spies"][fn] == 3 * fr.T
    # K4 runs where the form has an (I - K H) P step
    k4 = 0 if name in ("update_information", "joseph") else 3 * fr.T
    assert r["port"]["cov_update"] == k4
    for pkg in ("jax", "port"):
        p = r[pkg]["out"].p
        if name == "update_chol":
            assert np.isfinite(p[0]).all() and np.isnan(p[1:]).all()
        else:
            assert np.isfinite(p).all()
            assert r[pkg]["out"].n_update_features.sum() > 0


def test_chol_without_zupt_nan_from_first_update_as_jax():
    """Without ZUPT the chol form's first update is a visual one, and its
    H^T H is singular too (the features do not see a shift of every
    clone's position), so the Cholesky fails there: NaN in both packages
    from the same frame, after finite frames."""
    r = fr.run("update_chol_no_zupt")
    bad = {}
    for pkg in ("jax", "port"):
        out = r[pkg]["out"]
        ok = np.isfinite(out.p).all(axis=1)
        assert not ok.all()
        bad[pkg] = int(np.argmin(ok))
        assert bad[pkg] > 0 and not out.zupt.any()
    assert bad["port"] == bad["jax"]
    fr.check_pose("update_chol_no_zupt", "p")


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol=1e-10, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()),
                               err_msg=name)


def stacked(seed, m=30, d=20, zero_cols=(3, 11)):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(m, d))
    H[:, list(zero_cols)] = 0.0  # columns no row observes
    H[m - 4:] = 0.0  # padded rows
    return H, rng.normal(size=m)


@pytest.mark.parametrize("m", [30, 12])
def test_qr_compress_matches_jax(m):
    H, r = stacked(11, m=m)
    Rj, rj = jlinalg.qr_compress(jnp.asarray(H), jnp.asarray(r))
    Rp, rp = plinalg.qr_compress(t(H), t(r))
    assert Rp.shape == Rj.shape == (min(m, 20), 20)
    for R, rc in ((Rp.numpy(), rp.numpy()), (np.asarray(Rj), np.asarray(rj))):
        close(R.T @ R, H.T @ H, 1e-12, "R^T R")
        close(R.T @ rc, H.T @ r, 1e-12, "R^T r_c")
    # the same factor up to the signs of its rows
    s = np.sign(np.diagonal(Rp.numpy())) * np.sign(np.diagonal(np.asarray(Rj)))
    s[s == 0] = 1.0
    close(Rp.numpy() * s[:, None], Rj, 1e-12, "R")
    close(rp.numpy() * s, rj, 1e-12, "r_c")


def test_chol_compress_matches_jax():
    """Full column rank apart from the zero columns: finite, the Gram
    invariants hold, zero columns give zero rows."""
    H, r = stacked(12)
    Hj, rj = jlinalg.chol_compress(jnp.asarray(H), jnp.asarray(r))
    Hp, rp = plinalg.chol_compress(t(H), t(r))
    close(Hp, Hj, 1e-12, "H_thin")
    close(rp, rj, 1e-12, "r_thin")
    close(Hp.T @ Hp, H.T @ H, 1e-12, "Gram")
    close(Hp.T @ rp, H.T @ r, 1e-12, "H^T r")
    assert not Hp[[3, 11]].any()


def test_chol_compress_rank_deficient_is_nan_in_both():
    """Fewer independent rows than observed columns (ZUPT's 9 rows over 15
    columns, say): the Cholesky fails and both packages give NaN."""
    H, r = stacked(13, m=8)
    Hj, _ = jlinalg.chol_compress(jnp.asarray(H), jnp.asarray(r))
    Hp, _ = plinalg.chol_compress(t(H), t(r))
    assert np.isnan(np.asarray(Hj)).any() and torch.isnan(Hp).any()


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_masked_psd_solve_matches_jax(rhs):
    rng = np.random.default_rng(14)
    A = rng.normal(size=(4, 9, 9))
    S = A @ A.transpose(0, 2, 1) + np.eye(9)
    mask = rng.uniform(size=(4, 9)) > 0.3
    B = rng.normal(size=(4, 9) if rhs == "vector" else (4, 9, 3))
    B = B * (mask if rhs == "vector" else mask[..., None])
    Xj = jlinalg.masked_psd_solve(*map(jnp.asarray, (S, B, mask)), reg=1e-3)
    Xp = plinalg.masked_psd_solve(t(S), t(B), t(mask), reg=1e-3)
    close(Xp, Xj, 1e-12)
    assert not Xp.numpy()[~mask].any()


@pytest.fixture(scope="module")
def state():
    cfgd = fr.variant_cfg("update_information")
    d = fr.run("update_information")["port"]["final"]
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    jst = fr.jax_state_like(fr.initial_state(jcfg), d)
    return jcfg, pcfg, jst, filter_state_from_numpy(d, torch.float64, "cpu")


def test_information_update_matches_jax_and_the_direct_form(state):
    """On the information run's last state, with a stacked H over clone
    columns: the JAX function's dx and P, and (to the LU's conditioning)
    the direct form's."""
    jcfg, pcfg, jst, pst = state
    rng = np.random.default_rng(15)
    D = pst.P.shape[0]
    H = np.zeros((24, D))
    H[:, 22:70] = rng.normal(size=(24, 48))
    r = rng.normal(size=24) * 0.01
    js, jdx = jupd.information_update(jcfg, jst, jnp.asarray(H.T @ H),
                                      jnp.asarray(H.T @ r))
    ps, pdx = pupd.information_update(pcfg, pst, t(H.T @ H), t(H.T @ r))
    close(pdx, jdx, 1e-9, "dx")
    close(ps.P, js.P, 1e-9, "P")
    close(state_to_numpy(ps)["clones"]["R"], np.asarray(js.clones.R), 1e-9)
    direct = FilterConfig(**{**fr.variant_cfg("update_information"),
                             "update_form": "direct"})
    ds, ddx = pupd.apply_ekf_update(direct, pst, t(H), t(r))
    close(pdx, ddx, 1e-6, "dx vs direct")
    close(ps.P, ds.P, 1e-6, "P vs direct")
