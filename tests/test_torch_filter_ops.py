"""The filter's modules one by one: the port against the JAX package in
float64 on the CPU, on one mid-sequence state.

The state is the port's after 60 frames of the fixture of
``test_torch_filter.py`` (whose whole-run parity that test holds), carried
into both packages; frame 60 then feeds each module. Tolerances, stated per
case: 1e-12 where both packages run the same arithmetic in another order,
1e-11 for the IMU slab (as ``tests/test_propagation.py`` holds it), 1e-10
for the EKF update's P (a 444-row Cholesky solve); indices, masks and
decisions are identical. The nullspace basis is unique only up to an
orthogonal transform, so projected Jacobians compare as H^T H and H^T r.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import augment as jaug
from orcvio_tpu.filter import features as jfeat
from orcvio_tpu.filter import hybrid as jhyb
from orcvio_tpu.filter import propagation as jprop
from orcvio_tpu.filter import triangulation as jtri
from orcvio_tpu.filter import update as jupd
from orcvio_tpu.filter import zupt as jzupt
from orcvio_tpu.filter.pipeline import build_chi2_table as jax_chi2
from orcvio_tpu.filter.tracks import compact_tracks as jax_compact
from orcvio_tpu.math import linalg as jlin
from orcvio_tpu.math import quat as jquat
from orcvio_tpu.math import se3 as jse3
from orcvio_tpu.math import so3 as jso3
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import augment as paug
from orcvio_tpu_torch.filter import features as pfeat
from orcvio_tpu_torch.filter import hybrid as phyb
from orcvio_tpu_torch.filter import pipeline as ppipe
from orcvio_tpu_torch.filter import propagation as pprop
from orcvio_tpu_torch.filter import triangulation as ptri
from orcvio_tpu_torch.filter import update as pupd
from orcvio_tpu_torch.filter import zupt as pzupt
from orcvio_tpu_torch.filter.tracks import compact_tracks as port_compact
from orcvio_tpu_torch.math import linalg as plin
from orcvio_tpu_torch.math import quat as pquat
from orcvio_tpu_torch.math import se3 as pse3
from orcvio_tpu_torch.math import so3 as pso3
from tests.test_torch_filter import CFG, port_frame, sim_frames

torch.set_num_threads(1)

K_MID = 60
JCFG, PCFG = JaxConfig(**CFG), FilterConfig(**CFG)


def jj(fn, static=(0,)):
    """fn under jax.jit: one compile instead of one per eager primitive."""
    return jax.jit(fn, static_argnums=static)


def to_jax(template, d):
    """A JAX state like `template` with the leaves of numpy dict d."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        kw[f.name] = (to_jax(v, d[f.name]) if dataclasses.is_dataclass(v)
                      else jnp.asarray(d[f.name], v.dtype))
    return template.replace(**kw)


def t(x, dtype=torch.float64):
    x = np.array(x)
    return torch.as_tensor(x, dtype=dtype if x.dtype.kind == "f" else None)


def close(name, a, b, tol):
    """Compare numpy-able leaves, or two states field by field."""
    if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
        da = a if isinstance(a, dict) else state_to_numpy(a)
        db = b if isinstance(b, dict) else state_to_numpy(b)
        for k in da:
            close(f"{name}.{k}", da[k], db[k], tol)
        return
    if isinstance(a, dict):
        for k in a:
            close(f"{name}.{k}", a[k], b[k], tol)
        return
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def mid():
    """Both packages' states after K_MID frames, then through frame K_MID's
    propagation, augmentation and ingest (each step held against JAX)."""
    frames, st0 = sim_frames()
    ps = filter_state_from_numpy(state_to_numpy(st0), torch.float64, "cpu")
    pchi2 = ppipe.build_chi2_table(PCFG, torch.float64, device="cpu")
    for k in range(K_MID):
        ps, _ = ppipe.filter_step(PCFG, ps, port_frame(frames, k), pchi2)
    js = to_jax(st0, state_to_numpy(ps))
    fr = port_frame(frames, K_MID)
    jf = [jnp.asarray(np.asarray(x)) for x in fr]
    out = dict(js=js, ps=ps, fr=fr, jf=jf, jchi2=jax_chi2(JCFG, jnp.float64),
               pchi2=pchi2)

    # frame K_MID's propagation, augmentation and ingest
    def prefix(cfg, s, f):
        s = jprop.imu_batch(cfg, s, f[1], f[2], f[3], f[4])
        s = jaug.state_augmentation(cfg, s)
        cur = jaug.current_clone_slot(s)
        tab, _ = jfeat.add_observations(s.features, cur, *f[5:])
        return s.replace(features=tab), cur

    ps = pprop.imu_batch(PCFG, ps, fr.imu_t, fr.imu_gyro, fr.imu_acc,
                         fr.imu_mask)
    ps = paug.state_augmentation(PCFG, ps)
    pt, _ = pfeat.add_observations(ps.features, paug.current_clone_slot(ps),
                                   fr.fids, fr.uvs, fr.uv_vels, fr.meas_mask)
    out["ingested"] = (*jj(prefix)(JCFG, js, jf), ps.replace(features=pt))
    return out


def ingested(mid):
    """(JAX state, port state, cur slot) after frame K_MID's propagation,
    augmentation and ingest."""
    js, cur, ps = mid["ingested"]
    return js, ps, cur


def case_math(mid):
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=(20, 3)) * 0.7,
                        rng.normal(size=(4, 3)) * 1e-7,
                        np.array([[np.pi - 1e-4, 0, 0], [0, 0, 0]])])
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    q = np.asarray(jquat.from_rotation(jnp.asarray(R)))
    x = rng.normal(size=(5, 3)) + np.array([0, 0, 3.0])
    return [
        ("so3.exp", jso3.exp(jnp.asarray(w)), pso3.exp(t(w)), 1e-12),
        ("so3.log", jso3.log(jnp.asarray(R)), pso3.log(t(R)), 1e-12),
        ("so3.left_jacobian", jso3.left_jacobian(jnp.asarray(w)),
         pso3.left_jacobian(t(w)), 1e-12),
        ("so3.Hl", jso3.Hl(jnp.asarray(w)), pso3.Hl(t(w)), 1e-12),
        ("so3.vee", jso3.vee(jso3.hat(jnp.asarray(w))), pso3.vee(pso3.hat(t(w))),
         0),
        ("quat.from_rotation", q, pquat.from_rotation(t(R)), 1e-12),
        ("quat.to_rotation", jquat.to_rotation(jnp.asarray(q)),
         pquat.to_rotation(t(q)), 1e-12),
        ("quat.multiply", jquat.multiply(jnp.asarray(q[:-1]),
                                         jquat.inverse(jnp.asarray(q[1:]))),
         pquat.multiply(t(q[:-1]), pquat.inverse(t(q[1:]))), 1e-12),
        ("se3.project_image_df", jse3.project_image_df(jnp.asarray(x)),
         pse3.project_image_df(t(x)), 1e-15),
        ("se3.odot", jse3.odot(jse3.to_homogeneous(jnp.asarray(x))),
         pse3.odot(pse3.to_homogeneous(t(x))), 0),
        ("se3.make_pose", jse3.make_pose(jnp.asarray(R), jnp.asarray(w)),
         pse3.make_pose(t(R), t(w)), 0),
    ]


def case_linalg(mid):
    rng = np.random.default_rng(1)
    Hf = rng.normal(size=(6, 12, 3))
    Hf[:, 9:] = 0.0  # masked rows
    Hx = rng.normal(size=(6, 12, 20))
    Hx[:, 9:] = 0.0
    r = rng.normal(size=(6, 12))
    r[:, 9:] = 0.0
    jH, jr = jax.vmap(jlin.nullspace_project)(*map(jnp.asarray, (Hf, Hx, r)))
    pH, pr = plin.nullspace_project(t(Hf), t(Hx), t(r))
    A = rng.normal(size=(5, 12, 12))
    S = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(12)
    S[4] = -np.eye(12)  # not PD: inf
    jH, pH = np.asarray(jH), pH.numpy()
    return [
        ("chi_squared_table", jlin.chi_squared_table(0.95),
         plin.chi_squared_table(0.95), 0),
        ("nullspace H^T H", np.swapaxes(jH, 1, 2) @ jH,
         np.swapaxes(pH, 1, 2) @ pH, 1e-12),
        ("nullspace H^T r", np.einsum("fmd,fm->fd", jH, np.asarray(jr)),
         np.einsum("fmd,fm->fd", pH, pr.numpy()), 1e-12),
        ("chi2_gamma", jlin.chi2_gamma(jnp.asarray(S), jnp.asarray(r[:5])),
         plin.chi2_gamma(t(S), t(r[:5])), 1e-9),
    ]


def case_state_features_tracks(mid):
    js, ps, cur = ingested(mid)
    kill = np.arange(js.features.fid.shape[0]) % 3 == 0
    return [
        ("FilterState.create", ppipe.FilterState.create(PCFG, torch.float64,
                                                        "cpu"),
         jaug.FilterState.create_host(JCFG, np.float64), 0),
        ("features after ingest", js.features, ps.features, 0),
        ("track_lengths", jfeat.track_lengths(js.features),
         pfeat.track_lengths(ps.features), 0),
        ("free_rows", jj(jfeat.free_rows, ())(js.features, jnp.asarray(kill)),
         pfeat.free_rows(ps.features, t(kill)), 0),
        ("compact_tracks", jj(jax_compact, (2,))(js.features, js.clones.order, 6)._asdict(),
         port_compact(ps.features, ps.clones.order, 6)._asdict(), 0),
    ]


def case_propagation(mid):
    js, ps, fr, jf = mid["js"], mid["ps"], mid["fr"], mid["jf"]
    mask = np.asarray(fr.imu_mask).copy()
    mask[[0, 5]] = False  # a masked head and a gap: dt = 0 no-ops
    jo = jj(jprop.imu_batch)(JCFG, js, jf[1], jf[2], jf[3], jnp.asarray(mask))
    po = pprop.imu_batch(PCFG, ps, fr.imu_t, fr.imu_gyro, fr.imu_acc, t(mask))
    return [("imu_batch", jo, po, 1e-11)]


def case_augment(mid):
    js, ps, _ = ingested(mid)
    rate = 0.8
    jm, jfull = jj(jaug.select_prune_slots)(JCFG, js, jnp.asarray(rate))
    pm, pfull = paug.select_prune_slots(PCFG, ps, torch.tensor(rate))
    dx = np.random.default_rng(2).normal(size=js.P.shape[0]) * 1e-3
    return [
        ("current_clone_slot", jaug.current_clone_slot(js),
         paug.current_clone_slot(ps), 0),
        ("cam_poses", jaug.cam_poses(js), paug.cam_poses(ps), 1e-15),
        ("select_prune_slots", (jm, jfull), (pm, pfull), 0),
        ("prune_clones", jj(jaug.prune_clones, ())(js, jm), paug.prune_clones(ps, pm),
         1e-12),
        ("increment_state", jj(jaug.increment_state)(JCFG, js, jnp.asarray(dx)),
         paug.increment_state(PCFG, ps, t(dx)), 1e-14),
    ]


def _candidates(js, ps, cur, k=8):
    """Compacted tracks of the first k rows with >= 3 observations (the
    current one masked out), in both packages."""
    jct = jj(jax_compact, (2,))(js.features, js.clones.order, 6)
    pct = port_compact(ps.features, ps.clones.order, 6)
    rows = np.nonzero(np.asarray(jct.n_obs) >= 3)[0][:k]
    assert len(rows) >= 4
    jct = jax.tree.map(lambda a: a[rows], jct)
    pct = pct.take(torch.as_tensor(rows))
    return jct, pct


def case_triangulation(mid):
    js, ps, cur = ingested(mid)
    jct, pct = _candidates(js, ps, cur)
    jR, jt = jaug.cam_poses(js)
    pR, pt = paug.cam_poses(ps)
    jtri_ = jj(jtri.triangulate)(JCFG, jct, jR, jt)
    ptri_ = ptri.triangulate(PCFG, pct, pR, pt)
    assert np.asarray(jtri_.valid).sum() >= 2
    return [
        ("check_motion", jj(jtri.check_motion, (3,))(jct, jR, jt, 0.02),
         ptri.check_motion(pct, pR, pt, 0.02), 0),
        ("triangulate", jtri_._asdict(), ptri_._asdict(), 1e-9),
    ]


def _jacobians(mid):
    js, ps, cur = ingested(mid)
    jct, pct = _candidates(js, ps, cur)
    jR, jt = jaug.cam_poses(js)
    p_w = np.asarray(jj(jtri.triangulate)(JCFG, jct, jR, jt).p_world)
    jfj = jj(jupd.feature_jacobians)(JCFG, js, jct, jnp.asarray(p_w))
    pfj = pupd.feature_jacobians(PCFG, ps, pct, t(p_w))
    return js, ps, jfj, pfj


def case_feature_jacobians(mid):
    _, _, jfj, pfj = _jacobians(mid)
    jH, pH = np.asarray(jfj.H), pfj.H.numpy()
    out = [("feature_jacobians " + k, getattr(jfj, k), getattr(pfj, k), 1e-12)
           for k in ("H_raw", "Hf_raw", "r_raw", "dof", "usable")]
    return out + [
        ("H^T H", np.swapaxes(jH, 1, 2) @ jH, np.swapaxes(pH, 1, 2) @ pH, 1e-10),
        ("H^T r", np.einsum("fmd,fm->fd", jH, np.asarray(jfj.r)),
         np.einsum("fmd,fm->fd", pH, pfj.r.numpy()), 1e-10),
    ]


def case_gate_features(mid):
    js, ps, jfj, pfj = _jacobians(mid)
    jg = jj(jupd.gate_features)(JCFG, js, jfj, mid["jchi2"])
    pg = pupd.gate_features(PCFG, ps, pfj, mid["pchi2"])
    assert 0 < int(np.asarray(jg).sum())
    return [("gate_features", jg, pg, 0)]


def case_apply_ekf_update(mid):
    js, ps, cur = ingested(mid)
    rng = np.random.default_rng(3)
    D = js.P.shape[0]
    H = rng.normal(size=(40, D)) * 0.05
    H[30:] = 0.0  # padded rows decouple
    r = rng.normal(size=40) * 1e-3
    r[30:] = 0.0
    jo, jdx = jj(jupd.apply_ekf_update)(JCFG, js, jnp.asarray(H), jnp.asarray(r))
    po, pdx = pupd.apply_ekf_update(PCFG, ps, t(H), t(r))
    return [("apply_ekf_update dx", jdx, pdx, 1e-12),
            ("apply_ekf_update P", jo.P, po.P, 1e-10),
            ("apply_ekf_update state", jo.replace(P=jo.P * 0),
             po.replace(P=po.P * 0), 1e-11)]


def case_zupt(mid):
    js, ps, _ = ingested(mid)
    fr, jf = mid["fr"], mid["jf"]
    return [
        ("check_zupt_feat", jj(jzupt.check_zupt_feat)(JCFG, js),
         pzupt.check_zupt_feat(PCFG, ps), 0),
        ("check_zupt_imu", jj(jzupt.check_zupt_imu)(JCFG, js, jf[1], jf[2], jf[3],
                                                jf[4], mid["jchi2"]),
         pzupt.check_zupt_imu(PCFG, ps, fr.imu_t, fr.imu_gyro, fr.imu_acc,
                              fr.imu_mask, mid["pchi2"]), 0),
        ("zupt_update", jj(jzupt.zupt_update)(JCFG, js), pzupt.zupt_update(PCFG, ps),
         1e-10),
    ]


def case_hybrid(mid):
    js, ps, cur = ingested(mid)
    pcur = paug.current_clone_slot(ps)
    F = js.features.fid.shape[0]
    D = js.P.shape[0]
    in_state = np.asarray(js.features.in_state)
    assert in_state.sum() >= 2
    jer = jj(jhyb.ekf_feature_rows)(JCFG, js, cur)
    per = phyb.ekf_feature_rows(PCFG, ps, pcur)

    # prune the anchors of the in-state features (not the current clone)
    anchors = np.asarray(js.features.anchor_slot)[in_state]
    prune = np.zeros(JCFG.sw_size, bool)
    prune[anchors[anchors != int(cur)]] = True
    assert prune.any()

    kill = in_state & (np.arange(F) % 2 == 0)
    assert 0 < kill.sum() < in_state.sum()
    jrm = jj(jhyb.remove_state_features)(JCFG, js, jnp.asarray(kill))
    prm = phyb.remove_state_features(PCFG, ps, t(kill))

    # promotion inputs: 3 of 6 gathered candidates, rows not in the state
    rng = np.random.default_rng(4)
    rows = np.nonzero(~in_state & (np.asarray(js.features.fid) >= 0))[0][:6]
    cand = np.array([True, False, True, True, False, False])
    H_raw = rng.normal(size=(6, 12, D)) * 0.1
    Hf = rng.normal(size=(6, 12, 1))
    r_raw = rng.normal(size=(6, 12)) * 1e-3
    dx = rng.normal(size=D) * 1e-3
    jpro = jj(jhyb.promote_features)(JCFG, jrm, jnp.asarray(cand),
                                 jnp.asarray(H_raw), jnp.asarray(Hf),
                                 jnp.asarray(r_raw), jnp.asarray(dx),
                                 row_ids=jnp.asarray(rows))
    ppro = phyb.promote_features(PCFG, prm, t(cand), t(H_raw), t(Hf), t(r_raw),
                                 t(dx), row_ids=t(rows))
    assert (np.asarray(jpro.features.in_state).sum()
            > np.asarray(jrm.features.in_state).sum())

    jsp = jj(jax.vmap(jhyb.split_projection), ())(*map(jnp.asarray, (Hf, H_raw, r_raw)))
    psp = phyb.split_projection(t(Hf), t(H_raw), t(r_raw))
    return [
        ("ekf_base, idp_dim", (jhyb.ekf_base(JCFG), jhyb.idp_dim(JCFG)),
         (phyb.ekf_base(PCFG), phyb.idp_dim(PCFG)), 0),
        ("feature_world_points", jj(jhyb.feature_world_points, (1,))(js, JCFG),
         phyb.feature_world_points(ps, PCFG), 1e-12),
        ("ekf_feature_rows", jer._asdict(), per._asdict(), 1e-12),
        ("split_projection", jsp, psp, 1e-12),
        ("promote_features", jpro, ppro, 1e-10),
        ("remove_state_features", jrm, prm, 1e-12),
        ("reanchor_features",
         jj(jhyb.reanchor_features)(JCFG, js, jnp.asarray(prune), cur),
         phyb.reanchor_features(PCFG, ps, t(prune), pcur), 1e-10),
    ]


def case_top_k(mid):
    rng = np.random.default_rng(5)
    out = []
    for n, k in ((48, 8), (200, 32), (30, 30)):
        score = (rng.random(n) < 0.3).astype(np.float64)  # 0/1: many ties
        _, jidx = jax.lax.top_k(jnp.asarray(score), k)
        out.append((f"top_k {n} {k}", jidx, plin.top_k_indices(t(score), k), 0))
    return out


CASES = {f.__name__[5:]: f for f in (
    case_math, case_linalg, case_state_features_tracks, case_propagation,
    case_augment, case_triangulation, case_feature_jacobians,
    case_gate_features, case_apply_ekf_update, case_zupt, case_hybrid,
    case_top_k)}


@pytest.mark.parametrize("module", list(CASES))
def test_module_matches_jax(mid, module):
    for name, a, b, tol in CASES[module](mid):
        if isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                close(f"{name}[{i}]", x, y, tol)
        else:
            close(name, a, b, tol)


def test_float32_step_stays_float32(mid):
    """The card runs the filter in float32: one filter step from the same
    state in float32 keeps every floating field float32 (the forward-mode
    re-anchoring Jacobian included), finite, and within 1e-4 of the
    float64 step in p, R and v."""
    fr = mid["fr"]
    fr32 = ppipe.FrameInput(*(x.float() if x.is_floating_point() else x
                              for x in fr))
    ps32 = filter_state_from_numpy(state_to_numpy(mid["ps"]), torch.float32,
                                   "cpu")
    s32, out32 = ppipe.filter_step(PCFG, ps32, fr32,
                                   ppipe.build_chi2_table(PCFG, torch.float32,
                                                          device="cpu"))
    _, out64 = ppipe.filter_step(PCFG, mid["ps"], fr, mid["pchi2"])
    leaves = state_to_numpy(s32)
    stack = [leaves]
    while stack:
        for k, v in stack.pop().items():
            if isinstance(v, dict):
                stack.append(v)
            elif v.dtype.kind == "f":
                assert v.dtype == np.float32, k
                assert np.isfinite(v).all(), k
    for f in ("p", "R", "v"):
        np.testing.assert_allclose(getattr(out32, f).numpy(),
                                   getattr(out64, f).numpy(), rtol=0, atol=1e-4)
