"""Schmidt nuisance states, the port's functions against the JAX
package's, in float64 on the CPU. (The Schmidt variants' runs, 100
frames against the JAX package's, are in tests/test_torch_flags_hybrid.py.)

* On the port's schmidt run's last state (tests/flag_runs.py: nuisance
  slots in use, features anchored on them), as a JAX state too:
  convert.filter_state_from_numpy of it with intrinsics off the identity
  and back; schmidt_demote (the stale cross block zeroed),
  retire_nuisance and ekf_feature_rows with anchors on nuisance clones,
  each against the JAX function on the same inputs within 1e-10.
* apply_ekf_update in both Schmidt forms on a correlated P: P_nn
  bit-unchanged, the cross block carrying the full one-sided update (not
  half of it), P and dx within 1e-9 of JAX's; the information form with
  Schmidt states is JAX's qr fallback, and joseph_form is ignored, as in
  JAX.
* K4's plain version with its nb entry: P_nn kept bit for bit, the rest
  sym(P - K HP), exactly symmetric.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flag_runs as fr
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import hybrid as jh
from orcvio_tpu.filter import update as jupd
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import hybrid as ph
from orcvio_tpu_torch.filter import update as pupd
from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

torch.set_num_threads(1)


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol=1e-10, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def states():
    """The port's schmidt run's last state, with intrinsics off the
    identity (the Schmidt layout has no intrinsic columns, the state's
    fields are there all the same), as a JAX state and carried into the
    port by convert.filter_state_from_numpy."""
    cfgd = fr.variant_cfg("schmidt")
    d = dict(fr.port_run("schmidt")["final"])
    rng = np.random.default_rng(3)
    d["Tg"] = np.eye(3) + 0.01 * rng.normal(size=(3, 3))
    d["As"] = 0.01 * rng.normal(size=(3, 3))
    d["Ma"] = np.eye(3) + 0.01 * np.tril(rng.normal(size=(3, 3)))
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    jst = fr.jax_state_like(fr.initial_state(jcfg), d)
    pst = filter_state_from_numpy(state_to_numpy(jst), torch.float64, "cpu")
    ft = pst.features
    assert bool(pst.nui.valid.any())
    assert bool((ft.in_state & (ft.anchor_slot >= pcfg.sw_size)).any())
    return jcfg, pcfg, jst, pst


def test_state_converts_with_nuisance_and_intrinsics(states):
    _, _, jst, pst = states
    d, back = state_to_numpy(jst), state_to_numpy(pst)
    for key in ("Tg", "As", "Ma", "P"):
        np.testing.assert_array_equal(back[key], d[key])
    for key in ("R", "p", "t", "valid"):
        np.testing.assert_array_equal(back["nui"][key], d["nui"][key])
    np.testing.assert_array_equal(back["features"]["anchor_slot"],
                                  d["features"]["anchor_slot"])


def test_layout_matches_jax():
    cfgd = fr.variant_cfg("schmidt")
    jcfg, pcfg = JaxConfig(**cfgd), FilterConfig(**cfgd)
    assert ph.nui_base(pcfg) == jh.nui_base(jcfg) == pcfg.state_dim - 36
    assert pcfg.state_dim == jcfg.state_dim


def test_demote_matches_jax(states):
    """Half the in-state features anchored on the two oldest clones, both
    pruned: the first free nuisance slots take them in slot order."""
    jcfg, pcfg, jst, pst = states
    ft = pst.features
    rows = np.where(ft.in_state.numpy())[0]
    valid = np.where(pst.clones.valid.numpy())[0]
    anchor = ft.anchor_slot.numpy().copy()
    anchor[rows[0::4]], anchor[rows[2::4]] = valid[0], valid[1]
    pst = pst.replace(features=ft.replace(anchor_slot=t(anchor)))
    jst = jst.replace(features=jst.features.replace(
        anchor_slot=jnp.asarray(anchor)))
    prune = np.zeros(pcfg.sw_size, bool)
    prune[valid[:2]] = True
    assert int((~pst.nui.valid).sum()) >= 2
    theirs = jh.schmidt_demote(jcfg, jst, jnp.asarray(prune))
    ours = ph.schmidt_demote(pcfg, pst, t(prune))
    assert int(ours.nui.valid.sum()) == int(pst.nui.valid.sum()) + 2
    close(ours.P, theirs.P, name="P")
    for name in ("R", "p", "t", "valid"):
        close(getattr(ours.nui, name), getattr(theirs.nui, name), name=name)
    close(ours.features.anchor_slot, theirs.features.anchor_slot, 0, "anchor")
    # the moved block's cross with its old clone block is zero
    nb = ph.nui_base(pcfg)
    for n in np.where((ours.nui.valid & ~pst.nui.valid).numpy())[0]:
        rows = slice(nb + 6 * n, nb + 6 * n + 6)
        c = int(np.where(ours.nui.t[n].numpy() == pst.clones.t.numpy())[0][0])
        cols = slice(22 + 6 * c, 28 + 6 * c)
        assert not ours.P[rows, cols].any() and not ours.P[cols, rows].any()


def test_retire_matches_jax(states):
    """The features anchored on one nuisance slot dropped: that slot is
    retired, its covariance block zeroed."""
    jcfg, pcfg, jst, pst = states
    ft = pst.features
    sw = pcfg.sw_size
    slot = int(ft.anchor_slot[ft.in_state & (ft.anchor_slot >= sw)][0])
    keep = (ft.in_state & (ft.anchor_slot != slot)).numpy()
    pst = pst.replace(features=ft.replace(in_state=t(keep)))
    jst = jst.replace(features=jst.features.replace(
        in_state=jnp.asarray(keep)))
    theirs = jh.retire_nuisance(jcfg, jst)
    ours = ph.retire_nuisance(pcfg, pst)
    assert not bool(ours.nui.valid[slot - sw])
    close(ours.P, theirs.P, 0, "P")
    close(ours.nui.valid, theirs.nui.valid, 0, "valid")


def test_ekf_feature_rows_with_nuisance_anchors_match_jax(states):
    jcfg, pcfg, jst, pst = states
    ft = pst.features
    on_nui = (ft.in_state & (ft.anchor_slot >= pcfg.sw_size)).numpy()
    n_nui = 0
    for c in np.where(pst.clones.valid.numpy())[0]:
        theirs = jh.ekf_feature_rows(jcfg, jst, jnp.asarray(c))
        ours = ph.ekf_feature_rows(pcfg, pst, torch.tensor(c))
        for name in ("H", "r", "valid"):
            close(getattr(ours, name), getattr(theirs, name), name=name)
        n_nui += int((ours.valid.numpy() & on_nui).sum())
    assert n_nui > 0, "rows of features anchored on nuisance clones"


def _update_inputs(pcfg, pst, seed=4):
    """The schmidt state with a correlated P (nuisance and active states
    correlated) and a random stacked (H, r)."""
    rng = np.random.default_rng(seed)
    D = pcfg.state_dim
    A = rng.normal(size=(D, D)) * 0.03
    P = 1e-2 * np.eye(D) + A @ A.T
    H = rng.normal(size=(24, D)) * 0.5
    r = rng.normal(size=24) * 0.01
    return P, H, r


@pytest.mark.parametrize("form", ["direct", "qr"])
@pytest.mark.parametrize("ref", [False, True], ids=["textbook", "reference"])
def test_update_matches_jax(states, ref, form):
    jcfg, pcfg, jst, pst = states
    jcfg = dataclasses.replace(jcfg, schmidt_reference_semantics=ref,
                               update_form=form)
    pcfg = dataclasses.replace(pcfg, schmidt_reference_semantics=ref,
                               update_form=form)
    P, H, r = _update_inputs(pcfg, pst)
    js, jdx = jupd.apply_ekf_update(jcfg, jst.replace(P=jnp.asarray(P)),
                                    jnp.asarray(H), jnp.asarray(r))
    ps, pdx = pupd.apply_ekf_update(pcfg, pst.replace(P=t(P)), t(H), t(r))
    close(ps.P, js.P, 1e-9, "P")
    close(pdx, jdx, 1e-9, "dx")
    close(ps.imu.p, js.imu.p, 1e-9, "p")
    nb = ph.nui_base(pcfg)
    Pn = ps.P.numpy()
    np.testing.assert_array_equal(Pn[nb:, nb:], P[nb:, nb:])  # bit-unchanged
    np.testing.assert_array_equal(Pn, Pn.T)
    assert ref or not pdx[nb:].any(), "textbook: no nuisance increment"
    # the cross block carries the full one-sided update P_an - K_a (HP)_n
    if form == "direct":
        S = H @ P @ H.T + pcfg.observation_noise**2 * np.eye(len(r))
        K = np.linalg.solve(S, H @ P).T
        upd = K[:nb] @ (H @ P)[:, nb:]
        err_full = np.abs(Pn[:nb, nb:] - (P[:nb, nb:] - upd)).max()
        err_half = np.abs(Pn[:nb, nb:] - (P[:nb, nb:] - 0.5 * upd)).max()
        assert err_full < 1e-9 * np.abs(upd).max()
        assert err_half > 0.1 * np.abs(upd).max()


def test_information_form_is_jax_qr_fallback(states):
    """Under Schmidt the information form runs the qr-compressed update in
    both packages."""
    jcfg, pcfg, jst, pst = states
    P, H, r = _update_inputs(pcfg, pst, seed=6)
    out = {}
    for form in ("information", "qr"):
        jc = dataclasses.replace(jcfg, update_form=form)
        pc = dataclasses.replace(pcfg, update_form=form)
        js, jdx = jupd.apply_ekf_update(jc, jst.replace(P=jnp.asarray(P)),
                                        jnp.asarray(H), jnp.asarray(r))
        out[form] = pupd.apply_ekf_update(pc, pst.replace(P=t(P)), t(H), t(r))
        close(out[form][0].P, js.P, 1e-9, f"{form} P")
        close(out[form][1], jdx, 1e-9, f"{form} dx")
    assert torch.equal(out["information"][0].P, out["qr"][0].P)
    assert torch.equal(out["information"][1], out["qr"][1])


def test_joseph_form_ignored_under_schmidt(states):
    jcfg, pcfg, jst, pst = states
    P, H, r = _update_inputs(pcfg, pst, seed=7)
    jc = dataclasses.replace(jcfg, joseph_form=True)
    pc = dataclasses.replace(pcfg, joseph_form=True)
    js, jdx = jupd.apply_ekf_update(jc, jst.replace(P=jnp.asarray(P)),
                                    jnp.asarray(H), jnp.asarray(r))
    ps, pdx = pupd.apply_ekf_update(pc, pst.replace(P=t(P)), t(H), t(r))
    plain, _ = pupd.apply_ekf_update(pcfg, pst.replace(P=t(P)), t(H), t(r))
    close(ps.P, js.P, 1e-9, "P")
    close(pdx, jdx, 1e-9, "dx")
    assert torch.equal(ps.P, plain.P)


@pytest.mark.parametrize("D,q,nb", [(208, 444, 172), (232, 9, 196),
                                    (112, 24, 76), (50, 33, 0), (50, 33, 50)])
def test_cov_update_nb_keeps_the_nuisance_block(D, q, nb):
    rng = np.random.default_rng(D + q + nb)
    A = rng.normal(size=(D, D))
    P, K, H = (t(x) for x in (A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
                              rng.normal(size=(q, D)) * 0.1))
    out = cov_update(P, K, H, nb=nb)  # CPU tensors: the plain version
    assert torch.equal(out, cov_update_plain(P, K, H, H @ P, nb))
    assert torch.equal(out, out.T)
    assert torch.equal(out[nb:, nb:], P[nb:, nb:])
    full = cov_update_plain(P, K, H)
    keep = torch.zeros(D, D, dtype=torch.bool)
    keep[nb:, nb:] = True
    assert torch.equal(out[~keep], full[~keep])
    with pytest.raises(ValueError):
        cov_update(P, K, H, nb=D + 1)
