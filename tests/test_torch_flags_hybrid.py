"""The EKF-feature variants of the filter, the port's against the JAX
package's, in float64 on the CPU.

* 60 frames of filter_step (tests/flag_runs.py) under ``no_zupt``,
  ``pure_msckf`` (no EKF features: the stacked update is msckf_update's)
  and ``hybrid_3d`` (3-d inverse-depth EKF features), and the fixture's
  100 frames under ``schmidt`` (Schmidt nuisance states, nuisance_cap 6),
  ``schmidt_ref`` (the reference's Schmidt semantics) and
  ``calib_schmidt`` (with the IMU intrinsics, its IMU slab cut to 12
  samples): p, R, v per frame within 1e-8, identical decisions (update
  counts, ZUPT flags, promotions, re-anchorings, demotions,
  retirements), and the branch fired in both packages (under Schmidt at
  least one demotion and one retirement, the final P within 1e-9).
* The 3-d hybrid functions on the hybrid_3d run's last state (the port's)
  against the JAX functions on the same inputs: ekf_feature_rows (at every
  valid clone slot, the anchor-frame observation included),
  split_projection, remove_state_features, promote_features and
  reanchor_features.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import hybrid as jh
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import hybrid as ph

torch.set_num_threads(1)

NAMES = ["no_zupt", "pure_msckf", "hybrid_3d", "schmidt", "schmidt_ref",
         "calib_schmidt"]


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
        out = r[pkg]["out"]
        assert out.n_update_features.sum() > 0
        if name == "no_zupt":
            assert out.zupt.sum() == 0
        elif name == "pure_msckf":
            assert r[pkg]["promoted"].sum() == 0
            assert r[pkg]["final"]["P"].shape == (22 + 6 * 8,) * 2
        elif name == "hybrid_3d":
            assert r[pkg]["promoted"].sum() > 0
            assert r[pkg]["reanchored"].sum() > 0
            assert r[pkg]["final"]["P"].shape == (22 + 6 * 8 + 3 * 6,) * 2
        else:  # Schmidt
            D = 22 + 6 * 8 + 6 + 24 * (name == "calib_schmidt") + 6 * 6
            assert r[pkg]["final"]["P"].shape == (D, D)
            assert r[pkg]["demoted"].sum() > 0, "a clone demoted"
            assert r[pkg]["retired"].sum() > 0, "a nuisance slot retired"
    if name in ("schmidt", "schmidt_ref", "calib_schmidt"):
        for fn in ("schmidt_demote", "retire_nuisance"):
            assert r["jax"]["spies"][fn] >= 1, "traced into the JAX step"
            assert r["port"]["spies"][fn] == fr.n_frames(name)
        # the stacked, ZUPT and last-chance updates of every frame
        assert r["port"]["cov_update"] == 3 * fr.n_frames(name)
        for key in ("P", "Tg", "As", "Ma"):
            np.testing.assert_allclose(r["port"]["final"][key],
                                       r["jax"]["final"][key], rtol=0,
                                       atol=1e-9, err_msg=key)


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol=1e-10, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def states():
    cfgd = fr.variant_cfg("hybrid_3d")
    d = fr.run("hybrid_3d")["port"]["final"]
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    jst = fr.jax_state_like(fr.initial_state(jcfg), d)
    pst = filter_state_from_numpy(d, torch.float64, "cpu")
    assert int(pst.features.in_state.sum()) >= 2
    return jcfg, pcfg, jst, pst


def test_ekf_feature_rows_match_jax(states):
    jcfg, pcfg, jst, pst = states
    n_valid, at_anchor = 0, 0
    anchors = pst.features.anchor_slot[pst.features.in_state]
    for c in np.where(pst.clones.valid.numpy())[0]:
        theirs = jh.ekf_feature_rows(jcfg, jst, jnp.asarray(c))
        ours = ph.ekf_feature_rows(pcfg, pst, torch.tensor(c))
        for name in ("H", "r", "valid"):
            close(getattr(ours, name), getattr(theirs, name), name=name)
        n_valid += int(ours.valid.sum())
        at_anchor += int((anchors == c).sum())
    assert n_valid > 0 and at_anchor > 0


def test_split_projection_matches_jax():
    rng = np.random.default_rng(9)
    Hf, H, r = rng.normal(size=(12, 3)), rng.normal(size=(12, 40)), rng.normal(size=12)
    Hf[5] = 0.0  # a padded row
    theirs = jh.split_projection(*map(jnp.asarray, (Hf, H, r)))
    ours = ph.split_projection(t(Hf), t(H), t(r))
    for name, a, b in zip(("H1", "H2", "r1", "Ho", "ro"), ours, theirs):
        close(a, b, name=name)


def test_promote_features_matches_jax(states):
    """Up to 4 promotions into the slots that removing half the in-state
    features frees, from random candidate rows."""
    jcfg, pcfg, jst, pst = states
    rows = np.where(pst.features.in_state.numpy())[0]
    kill = np.zeros(pst.features.fid.shape[0], bool)
    kill[rows[::2]] = True
    jst = jh.remove_state_features(jcfg, jst, jnp.asarray(kill))
    pst = ph.remove_state_features(pcfg, pst, t(kill))
    close(pst.P, jst.P, 0, "removed P")
    close(pst.features.in_state, jst.features.in_state, 0, "removed")

    rng = np.random.default_rng(10)
    Kc, M, D = 6, 12, pst.P.shape[0]
    H_raw = rng.normal(size=(Kc, M, D)) * 0.1
    Hf = rng.normal(size=(Kc, M, 3))
    r_raw = rng.normal(size=(Kc, M)) * 0.01
    dx = rng.normal(size=D) * 1e-3
    cand = np.asarray([True, False, True, True, False, True])
    free = np.where(~pst.features.in_state.numpy()
                    & (pst.features.fid.numpy() >= 0))[0]
    row_ids = np.resize(free, Kc).astype(np.int32)
    theirs = jh.promote_features(jcfg, jst, jnp.asarray(cand), *map(
        jnp.asarray, (H_raw, Hf, r_raw, dx)), row_ids=jnp.asarray(row_ids))
    ours = ph.promote_features(pcfg, pst, t(cand), t(H_raw), t(Hf), t(r_raw),
                               t(dx), t(row_ids))
    assert int(ours.features.in_state.sum()) > int(pst.features.in_state.sum())
    close(ours.P, theirs.P, name="P")
    for name in ("in_state", "state_slot", "idp"):
        close(getattr(ours.features, name), getattr(theirs.features, name),
              name=name)


def test_reanchor_matches_jax(states):
    """Half the in-state features anchored on a clone that is pruned
    (re-anchored to the current clone), the others on the current clone
    (kept: the JAX package's fallback rows, ROADMAP section 3 item 16)."""
    jcfg, pcfg, jst, pst = states
    ft = pst.features
    rows = np.where(ft.in_state.numpy())[0]
    valid = np.where(pst.clones.valid.numpy())[0]
    old, cur = valid[0], valid[-1]
    anchor = ft.anchor_slot.numpy().copy()
    anchor[rows[::2]], anchor[rows[1::2]] = old, cur
    pst = pst.replace(features=ft.replace(anchor_slot=t(anchor)))
    jst = jst.replace(features=jst.features.replace(
        anchor_slot=jnp.asarray(anchor)))
    prune = np.zeros(pcfg.sw_size, bool)
    prune[old] = True
    theirs = jh.reanchor_features(jcfg, jst, jnp.asarray(prune), jnp.asarray(cur))
    ours = ph.reanchor_features(pcfg, pst, t(prune), torch.tensor(cur))
    moved = ours.features.anchor_slot.numpy() != anchor
    assert moved[rows[::2]].all() and not moved[rows[1::2]].any()
    close(ours.P, theirs.P, name="P")
    close(ours.features.idp, theirs.features.idp, name="idp")
    close(ours.features.anchor_slot, theirs.features.anchor_slot, 0, "anchor")
